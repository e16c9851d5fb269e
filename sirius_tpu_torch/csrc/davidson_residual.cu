// K2: Davidson residual, convergence mask and Teter preconditioner.
//
// Replaces the XLA fusion of the step body of
// sirius_tpu/solvers/davidson.py::davidson (:141-148: guarded Ritz values
// from the carried H X / S X, r = (HX - eps SX) * mask, row norms, the
// convergence mask) with _precondition (:100-104), and the exit values of
// the same function (:209-213).
//
// Two element types from one template: complex128 blocks (the k-point
// path) and float64 blocks (the Gamma packed-real path of
// sirius_tpu/ops/gamma.py::davidson_gamma :270-281, where the same solver
// runs on packed real vectors). A real element is read as a complex one
// with a zero imaginary part, so both share every line of arithmetic.
//
// Bound on the H100: bytes. Per element of a [B*nb, ngk] row it reads x,
// hx, sx (48 bytes complex, 24 real), h_diag, o_diag and mask (24 bytes,
// shared by the nb rows of a batch), writes w (16 bytes complex, 8 real),
// and does about 30 flops (complex) or 15 (real).
//
// Three passes over a row: (1) <x|H x> and <x|S x>, (2) |r|^2 with r
// rebuilt from hx - eps*sx (the expanded form |hx|^2 - 2 eps <hx|sx> +
// eps^2 |sx|^2 cancels catastrophically near convergence), (3) w. Every
// row sum is a strided per-thread sum in a fixed order followed by a
// shared-memory tree, so a run is bit-reproducible.
//
// Two grids, chosen by kernels/davidson_residual.py::davidson_residual_plan:
// - cluster 1, rows shorter than 32 KB (every 2-atom deck): one block a
//   row (residual_rows); passes 2 and 3 re-read the row from L2.
// - cluster C of 2, 4 or 8 blocks a row (residual_rows_cluster): one block
//   a row left most SMs idle at full width (129 rows on 132 SMs at 54
//   atoms, 8 warps an SM, latency-bound) and re-read hx and sx. Block r of
//   the cluster copies elements [r slice, (r + 1) slice) of x, hx and sx
//   into its shared memory with cp.async (every load in flight at once),
//   so the row is read from device memory once. Each block reduces its
//   slice as above, writes its partial sums to shared memory and syncs
//   the cluster; every block then reads the C partials through
//   distributed shared memory in rank order 0..C-1, so all hold the same
//   eps and |r|, and a run is bit-reproducible. Pass 2 writes w from
//   shared memory with 16-byte stores (the scalar head and tail around
//   them where a slice does not start or end on a 16-byte boundary) as if
//   the row had not converged, and a converged row's w is zeroed after
//   |r| is known: one wait for the cluster fewer on every row. The block
//   sums are warp shuffle trees and the warps' sums in order.
//
// fp32 instantiations (davidson_residual_c64 on complex64 blocks,
// davidson_residual_f32 on float32 packed-real blocks) take float32 tables
// and reduce in float32, as the JAX package's complex64 davidson computes
// its Ritz values and residual norms (real_dtype_of float32 throughout):
// the evals and rnorm they return are float32. Half the bytes of the fp64
// ones, the same design.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "precision.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// element access: a real element is a complex one with imaginary part 0
__device__ inline double2 load(const double2* p, long long i) { return p[i]; }
__device__ inline float2 load(const float2* p, long long i) { return p[i]; }
__device__ inline double2 load(const double* p, long long i) {
    return make_double2(p[i], 0.0);
}
__device__ inline float2 load(const float* p, long long i) {
    return make_float2(p[i], 0.0f);
}
template <typename R>
__device__ inline void store(cplx_t<R>* p, long long i, R re, R im) {
    p[i] = make_cplx<R>(re, im);
}
template <typename R>
__device__ inline void store(R* p, long long i, R re, R) {
    p[i] = re;
}

template <typename R>
__device__ R block_sum(R v, R* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const R out = sh[0];
    __syncthreads();
    return out;
}

// x, hx, sx, w: [nrows_total, ngk] of T (cplx_t<R> or R); h_diag, o_diag,
// mask: [nrows_total/nb, ngk] of R. mask may be null (exit values: no mask,
// as davidson.py:209-213); w may be null (exit values: no preconditioned
// block).
template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
residual_rows(const T* __restrict__ x, const T* __restrict__ hx,
              const T* __restrict__ sx,
              const R* __restrict__ h_diag,
              const R* __restrict__ o_diag,
              const R* __restrict__ mask, R res_tol,
              R* __restrict__ evals, R* __restrict__ rnorm,
              T* __restrict__ w, int nb, int ngk) {
    __shared__ R sh[kThreads];
    const long long row = blockIdx.x;
    const long long off = row * (long long)ngk;
    const long long doff = (row / nb) * (long long)ngk;

    R num = 0, den = 0;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const auto xv = load(x, off + g);
        const auto hv = load(hx, off + g);
        const auto sv = load(sx, off + g);
        num += xv.x * hv.x + xv.y * hv.y;  // Re(conj(x) * hx)
        den += xv.x * sv.x + xv.y * sv.y;
    }
    num = block_sum<R>(num, sh);
    den = block_sum<R>(den, sh);
    const R ev = num / (fabs(den) > R(1e-30) ? den : R(1));

    R r2 = 0;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const R m = mask != nullptr ? mask[doff + g] : R(1);
        const auto hv = load(hx, off + g);
        const auto sv = load(sx, off + g);
        const R rr = (hv.x - ev * sv.x) * m;
        const R ri = (hv.y - ev * sv.y) * m;
        r2 += rr * rr + ri * ri;
    }
    r2 = block_sum<R>(r2, sh);
    const R rn = sqrt(r2);
    if (threadIdx.x == 0) {
        evals[row] = ev;
        rnorm[row] = rn;
    }
    if (w == nullptr) return;

    const bool conv = rn < res_tol;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const R m = mask != nullptr ? mask[doff + g] : R(1);
        R wr = 0, wi = 0;
        if (!conv) {
            const auto hv = load(hx, off + g);
            const auto sv = load(sx, off + g);
            R p = h_diag[doff + g] - ev * o_diag[doff + g];
            p = R(0.5) * (R(1) + p + sqrt(R(1) + (p - R(1)) * (p - R(1))));
            wr = (hv.x - ev * sv.x) * m / p;
            wi = (hv.y - ev * sv.y) * m / p;
        }
        store<R>(w, off + g, wr * m, wi * m);
    }
}

// the element of w from its real and imaginary parts
template <typename T, typename R>
__device__ inline T make_elem(R re, R im);
template <>
__device__ inline double2 make_elem<double2, double>(double re, double im) {
    return make_double2(re, im);
}
template <>
__device__ inline float2 make_elem<float2, float>(float re, float im) {
    return make_float2(re, im);
}
template <>
__device__ inline double make_elem<double, double>(double re, double) {
    return re;
}
template <>
__device__ inline float make_elem<float, float>(float re, float) {
    return re;
}

// 16 bytes of elements of T, stored with one instruction
template <typename T>
struct __align__(16) Vec16 {
    T e[16 / sizeof(T)];
};

constexpr int kWarps = kThreads / 32;

// thread 0's block totals of a and b: each warp's shuffle tree, then the
// warps' sums in order (deterministic). sh holds 2 kWarps values; the
// caller syncs (the cluster barrier) before sh is written again.
template <typename R>
__device__ void block_sum2(R& a, R& b, R* sh) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if ((threadIdx.x & 31) == 0) {
        sh[threadIdx.x >> 5] = a;
        sh[kWarps + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a = 0;
        b = 0;
        for (int i = 0; i < kWarps; ++i) {
            a += sh[i];
            b += sh[kWarps + i];
        }
    }
}

// the sum of the cluster's partial sums at slot of each block's part, in
// rank order
template <typename R>
__device__ R cluster_sum(cg::cluster_group& cluster, R* part, int slot) {
    R total = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
        total += cluster.map_shared_rank(part, r)[slot];
    return total;
}

// the grid: C blocks a row, a cluster a row; slice elements a block.
// Shared memory: x, hx, sx of the block's slice, [slice] T each.
//
// Pass 2 also writes w, before |r| is known: the row's preconditioned
// residual, as if it had not converged (every element's w = r (1 / p) m,
// p from h_diag, o_diag and eps). A row that has converged (|r| < res_tol)
// then has its slice of w overwritten with zeros, as pass 3 of
// residual_rows writes it. Converged rows pay their w twice; every row
// saves a pass and a wait for the cluster.
template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
residual_rows_cluster(const T* __restrict__ x, const T* __restrict__ hx,
                      const T* __restrict__ sx,
                      const R* __restrict__ h_diag,
                      const R* __restrict__ o_diag,
                      const R* __restrict__ mask, R res_tol,
                      R* __restrict__ evals, R* __restrict__ rnorm,
                      T* __restrict__ w, int nb, int ngk, int slice) {
    extern __shared__ __align__(16) unsigned char k2_smem[];
    __shared__ R sh[2 * kWarps];
    // this block's partial sums: <x|hx>, <x|sx>, |r|^2; the row's eps, |r|
    __shared__ R part[3];
    __shared__ R row_ev[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const long long row = blockIdx.x / cluster.num_blocks();
    const int lo = rank * slice;
    const int n = max(0, min(ngk, lo + slice) - lo);
    const long long off = row * (long long)ngk + lo;
    const long long doff = (row / nb) * (long long)ngk + lo;
    T* xs = reinterpret_cast<T*>(k2_smem);
    T* hs = xs + slice;
    T* ss = hs + slice;

    for (int i = threadIdx.x; i < n; i += kThreads) {
        __pipeline_memcpy_async(xs + i, x + off + i, sizeof(T));
        __pipeline_memcpy_async(hs + i, hx + off + i, sizeof(T));
        __pipeline_memcpy_async(ss + i, sx + off + i, sizeof(T));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    R num = 0, den = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const auto xv = load(xs, i);
        const auto hv = load(hs, i);
        const auto sv = load(ss, i);
        num += xv.x * hv.x + xv.y * hv.y;  // Re(conj(x) * hx)
        den += xv.x * sv.x + xv.y * sv.y;
    }
    block_sum2<R>(num, den, sh);
    if (threadIdx.x == 0) {
        part[0] = num;
        part[1] = den;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
        const R tnum = cluster_sum<R>(cluster, part, 0);
        const R tden = cluster_sum<R>(cluster, part, 1);
        row_ev[0] = tnum / (fabs(tden) > R(1e-30) ? tden : R(1));
    }
    __syncthreads();
    const R ev = row_ev[0];

    // |r|^2 over the slice and w as if not converged: the elements before
    // the slice's first 16-byte boundary of w (whose base is on one, the
    // wrapper checks), the 16-byte vectors, the rest
    constexpr int kEpv = 16 / sizeof(T);
    const int head = min(n, (int)((kEpv - off % kEpv) % kEpv));
    const int nvec = (n - head) / kEpv;
    const int rest = head + nvec * kEpv;
    R r2 = 0;
    auto elem = [&](int i) -> T {
        const R m = mask != nullptr ? mask[doff + i] : R(1);
        const auto hv = load(hs, i);
        const auto sv = load(ss, i);
        const R rr = (hv.x - ev * sv.x) * m;
        const R ri = (hv.y - ev * sv.y) * m;
        r2 += rr * rr + ri * ri;
        if (w == nullptr) return T();
        R p = h_diag[doff + i] - ev * o_diag[doff + i];
        p = R(0.5) * (R(1) + p + sqrt(R(1) + (p - R(1)) * (p - R(1))));
        // one division an element (the plain version divides both parts:
        // the two differ by rounding)
        const R ip = R(1) / p;
        return make_elem<T, R>(rr * ip * m, ri * ip * m);
    };
    Vec16<T>* wv = w != nullptr
                       ? reinterpret_cast<Vec16<T>*>(w + off + head)
                       : nullptr;
#pragma unroll 2
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
        Vec16<T> out;
#pragma unroll
        for (int k = 0; k < kEpv; ++k) out.e[k] = elem(head + v * kEpv + k);
        if (wv != nullptr) wv[v] = out;
    }
    for (int i = threadIdx.x; i < head + n - rest; i += kThreads) {
        const int j = i < head ? i : rest + i - head;
        const T e = elem(j);
        if (w != nullptr) w[off + j] = e;
    }
    R unused = 0;
    block_sum2<R>(r2, unused, sh);
    if (threadIdx.x == 0) part[2] = r2;
    cluster.sync();
    if (threadIdx.x == 0) {
        row_ev[1] = sqrt(cluster_sum<R>(cluster, part, 2));
        if (rank == 0) {
            evals[row] = ev;
            rnorm[row] = row_ev[1];
        }
    }
    // every block arrives once its partial sums are read, and waits before
    // it leaves (its shared memory must outlive the other blocks' reads)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    __syncthreads();
    if (w != nullptr && row_ev[1] < res_tol) {
        // converged: w = 0 * m, as residual_rows writes it
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const R m = mask != nullptr ? mask[doff + i] : R(1);
            w[off + i] = make_elem<T, R>(R(0) * m, R(0) * m);
        }
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T, typename R>
int launch(const void* x, const void* hx, const void* sx, const R* h_diag,
           const R* o_diag, const R* mask, double res_tol, R* evals,
           R* rnorm, void* w, int nrows_total, int nb, int ngk, int cluster,
           int slice, void* stream) {
    if (nrows_total <= 0) return (int)cudaGetLastError();
    if (cluster <= 1) {
        residual_rows<T, R><<<nrows_total, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const T*)x, (const T*)hx, (const T*)sx, h_diag, o_diag, mask,
            (R)res_tol, evals, rnorm, (T*)w, nb, ngk);
        return (int)cudaGetLastError();
    }
    const size_t smem = 3 * (size_t)slice * sizeof(T);
    auto kernel = residual_rows_cluster<T, R>;
    static size_t smem_set = 0;  // per instantiation
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();  // a refused call also sets the last error
            return (int)e;
        }
        smem_set = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)nrows_total * (unsigned)cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, (const T*)x, (const T*)hx, (const T*)sx, h_diag, o_diag,
        mask, (R)res_tol, evals, rnorm, (T*)w, nb, ngk, slice);
    if (e != cudaSuccess) {
        cudaGetLastError();  // a refused launch also sets the last error
        return (int)e;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int davidson_residual(const void* x, const void* hx, const void* sx,
                                 const double* h_diag, const double* o_diag,
                                 const double* mask, double res_tol,
                                 double* evals, double* rnorm, void* w,
                                 int nrows_total, int nb, int ngk, int cluster,
                                 int slice, void* stream) {
    return launch<double2, double>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                   evals, rnorm, w, nrows_total, nb, ngk,
                                   cluster, slice, stream);
}

extern "C" int davidson_residual_f64(const void* x, const void* hx,
                                     const void* sx, const double* h_diag,
                                     const double* o_diag, const double* mask,
                                     double res_tol, double* evals,
                                     double* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, int cluster, int slice,
                                     void* stream) {
    return launch<double, double>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                  evals, rnorm, w, nrows_total, nb, ngk,
                                  cluster, slice, stream);
}

extern "C" int davidson_residual_c64(const void* x, const void* hx,
                                     const void* sx, const float* h_diag,
                                     const float* o_diag, const float* mask,
                                     double res_tol, float* evals,
                                     float* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, int cluster, int slice,
                                     void* stream) {
    return launch<float2, float>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                 evals, rnorm, w, nrows_total, nb, ngk,
                                 cluster, slice, stream);
}

extern "C" int davidson_residual_f32(const void* x, const void* hx,
                                     const void* sx, const float* h_diag,
                                     const float* o_diag, const float* mask,
                                     double res_tol, float* evals,
                                     float* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, int cluster, int slice,
                                     void* stream) {
    return launch<float, float>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                evals, rnorm, w, nrows_total, nb, ngk,
                                cluster, slice, stream);
}
