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
// Design: one block per (batch, band) row. Three passes over the row:
// (1) <x|H x> and <x|S x>, (2) |r|^2 with r rebuilt from hx - eps*sx (the
// expanded form |hx|^2 - 2 eps <hx|sx> + eps^2 |sx|^2 cancels
// catastrophically near convergence), (3) w. Every row sum is a strided
// per-thread sum in a fixed order followed by a shared-memory tree, so a
// run is bit-reproducible. Passes 2 and 3 re-read the row, which a 126 KB
// (ngk 7880) row keeps in L2.
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
#include <cuda_runtime.h>

#include "precision.cuh"

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

template <typename T, typename R>
int launch(const void* x, const void* hx, const void* sx, const R* h_diag,
           const R* o_diag, const R* mask, double res_tol, R* evals,
           R* rnorm, void* w, int nrows_total, int nb, int ngk,
           void* stream) {
    if (nrows_total > 0)
        residual_rows<T, R><<<nrows_total, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const T*)x, (const T*)hx, (const T*)sx, h_diag, o_diag, mask,
            (R)res_tol, evals, rnorm, (T*)w, nb, ngk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int davidson_residual(const void* x, const void* hx, const void* sx,
                                 const double* h_diag, const double* o_diag,
                                 const double* mask, double res_tol,
                                 double* evals, double* rnorm, void* w,
                                 int nrows_total, int nb, int ngk,
                                 void* stream) {
    return launch<double2, double>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                   evals, rnorm, w, nrows_total, nb, ngk,
                                   stream);
}

extern "C" int davidson_residual_f64(const void* x, const void* hx,
                                     const void* sx, const double* h_diag,
                                     const double* o_diag, const double* mask,
                                     double res_tol, double* evals,
                                     double* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, void* stream) {
    return launch<double, double>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                  evals, rnorm, w, nrows_total, nb, ngk,
                                  stream);
}

extern "C" int davidson_residual_c64(const void* x, const void* hx,
                                     const void* sx, const float* h_diag,
                                     const float* o_diag, const float* mask,
                                     double res_tol, float* evals,
                                     float* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, void* stream) {
    return launch<float2, float>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                 evals, rnorm, w, nrows_total, nb, ngk,
                                 stream);
}

extern "C" int davidson_residual_f32(const void* x, const void* hx,
                                     const void* sx, const float* h_diag,
                                     const float* o_diag, const float* mask,
                                     double res_tol, float* evals,
                                     float* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, void* stream) {
    return launch<float, float>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                evals, rnorm, w, nrows_total, nb, ngk, stream);
}
