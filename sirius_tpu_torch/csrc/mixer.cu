// K14a / K14b: the device Anderson mixer of the fused SCF step.
//
// Replace sirius_tpu/dft/mixer.py::device_mix (:348-414), which XLA fuses
// inside the JAX package's jitted step: with f = x_new - x_in and the
// history of the last cnt pairs (x_i, f_i), oldest first,
//   K14a  a_ij = Re sum_x conj(f - f_i) w (f - f_j),
//         b_i  = Re sum_x conj(f - f_i) w f,
//         rms  = sqrt(max(Re sum_x rms_w |f|^2, 0));
//   K14b  the eigendecomposition of the m x m system a = V diag(ew) V^T
//         (0.5 (a + a^T) in the JAX package, the same matrix here: a is
//         built symmetric), the cut ew > 1e-12 max(ew_max, 0),
//         g = V diag(1/ew on the kept) V^T b, g = 0 where a or b is not
//         finite (the JAX package sets a := I there and zeroes g, the same
//         g) or cnt == 0;
//         x_opt = x_in - sum_i g_i (x_in - x_i), f_opt = f - sum_i g_i (f - f_i),
//         x_mixed = x_opt + beta f_opt, or x_in + beta f where any
//         component of x_mixed is not finite; the pair (x_in, f) into the
//         ring slot `push`; eha = Re sum_{x < ng} eha_w |x_mixed - x_new|^2.
// "linear" is cnt = 0: no Gram, g = 0, x_mixed = x_in + beta f (the
// fallback gives the same vector).
//
// The history is a ring of m rows in two [m, nx] complex128 buffers,
// written in place; row i of the system (oldest first, the JAX package's
// row order after its roll) is slot (head + i) mod m. The host keeps cnt
// and head from the iteration count, so nothing is read back.
//
// Bound on the H100: bytes for the two grid passes (K14a reads x_in, x_new,
// w, rms_w and cnt history rows; K14b reads x_in, x_new and 2 cnt rows and
// writes x_mixed and one row pair), latency for the solve (one block).
//
// Design: no fp64 atomics; every sum is reduced in two fixed passes. The
// update forms each complex value as the plain version's complex
// arithmetic does (real g and beta times a complex value as (r + 0i) z,
// each product and sum rounded apart), so the damped step is its bits and
// a NaN lands where it lands there. K14a:
// a fixed grid walks tiles of kTile values of x in order; a tile's rows
// f - f_i are staged in shared memory and each thread owns up to kPer of
// the cnt (cnt + 1) / 2 + cnt + 1 sums, carried in registers across tiles;
// the per-block partials are then added in block order by one block. The
// solve is one block: cyclic Jacobi on the cnt x cnt matrix in dynamic
// shared memory (cnt <= 64: 67 KB at most, above the 48 KB default, so the
// launch raises the kernel's limit there), one rotation at a time over the
// threads, until every off-diagonal entry is below 1e-16 of the geometric
// mean of its diagonal pair or 60 sweeps. The update is two grid passes
// around an integer flag (atomicOr of each block's "not finite", exact in
// any order): the first forms x_mixed, the second applies the fallback
// where the flag is set, pushes the pair and forms the eha partials, which
// one block adds in order.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 64;
constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kPer = (kMaxRows * (kMaxRows + 1) / 2 + kMaxRows + 1 +
                      kThreads - 1) / kThreads;
constexpr int kMaxBlocks = 256;

inline int grid_for(long long n, int per_block) {
    long long b = (n + per_block - 1) / per_block;
    if (b < 1) b = 1;
    if (b > kMaxBlocks) b = kMaxBlocks;
    return (int)b;
}

__device__ __forceinline__ int slot_of(int i, int head, int m) {
    return (head + i) % m;
}

// the number of sums of K14a: the upper triangle of a, b, rms
__host__ __device__ __forceinline__ int num_sums(int cnt) {
    return cnt * (cnt + 1) / 2 + cnt + 1;
}

// sum index p -> (kind, i, j): p < npairs the pair (i <= j) in row-major
// upper-triangle order, then b_i, then rms
__device__ void decode(int p, int cnt, int* i, int* j) {
    const int npairs = cnt * (cnt + 1) / 2;
    if (p < npairs) {
        int r = 0, left = p;
        while (left >= cnt - r) {
            left -= cnt - r;
            ++r;
        }
        *i = r;
        *j = r + left;
    } else if (p < npairs + cnt) {
        *i = -1;
        *j = p - npairs;
    } else {
        *i = -2;
        *j = 0;
    }
}

__global__ void __launch_bounds__(kThreads)
gram_partials(const double2* __restrict__ x_in,
              const double2* __restrict__ x_new,
              const double2* __restrict__ hf, const double* __restrict__ w,
              const double* __restrict__ rms_w, int cnt, int head, int m,
              long long nx, double* __restrict__ partials) {
    __shared__ double2 s_df[kMaxRows * kTile];
    __shared__ double2 s_f[kTile];
    __shared__ double s_w[kTile];
    __shared__ double s_rw[kTile];
    const int nsum = num_sums(cnt);
    int pi[kPer], pj[kPer];
    double acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        acc[k] = 0.0;
        const int p = threadIdx.x + k * kThreads;
        if (p < nsum) decode(p, cnt, &pi[k], &pj[k]);
    }
    const long long ntile = (nx + kTile - 1) / kTile;
    for (long long tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
        const long long x0 = tile * kTile;
        const int len = (int)((nx - x0) < kTile ? (nx - x0) : kTile);
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += kThreads) {
            if (t < len) {
                const double2 a = x_new[x0 + t], b = x_in[x0 + t];
                s_f[t] = make_double2(a.x - b.x, a.y - b.y);
                s_w[t] = w[x0 + t];
                s_rw[t] = rms_w[x0 + t];
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < cnt * kTile; e += kThreads) {
            const int i = e / kTile, t = e - i * kTile;
            if (t < len) {
                const double2 h = hf[(long long)slot_of(i, head, m) * nx + x0 + t];
                s_df[e] = make_double2(s_f[t].x - h.x, s_f[t].y - h.y);
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int p = threadIdx.x + k * kThreads;
            if (p >= nsum) continue;
            double s = acc[k];
            if (pi[k] >= 0) {
                const double2* u = s_df + pi[k] * kTile;
                const double2* v = s_df + pj[k] * kTile;
                for (int t = 0; t < len; ++t)
                    s += (u[t].x * v[t].x + u[t].y * v[t].y) * s_w[t];
            } else if (pi[k] == -1) {
                const double2* u = s_df + pj[k] * kTile;
                for (int t = 0; t < len; ++t)
                    s += (u[t].x * s_f[t].x + u[t].y * s_f[t].y) * s_w[t];
            } else {
                for (int t = 0; t < len; ++t)
                    s += s_rw[t] * (s_f[t].x * s_f[t].x + s_f[t].y * s_f[t].y);
            }
            acc[k] = s;
        }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p < nsum) partials[(long long)blockIdx.x * nsum + p] = acc[k];
    }
}

// out: a [m, m] (both triangles), b [m], rms [1]
__global__ void __launch_bounds__(kThreads)
gram_reduce(const double* __restrict__ partials, int nblocks, int cnt, int m,
            double* __restrict__ out) {
    const int nsum = num_sums(cnt);
    for (int p = threadIdx.x; p < nsum; p += kThreads) {
        double s = 0.0;
        for (int b = 0; b < nblocks; ++b) s += partials[(long long)b * nsum + p];
        int i, j;
        decode(p, cnt, &i, &j);
        if (i >= 0) {
            out[i * m + j] = s;
            out[j * m + i] = s;
        } else if (i == -1) {
            out[m * m + j] = s;
        } else {
            out[m * m + m] = sqrt(s < 0.0 ? 0.0 : s);  // NaN stays NaN
        }
    }
}

// g [m] from the system of gram_reduce (one block of kMaxRows threads).
// Shared memory (dynamic, solve_smem bytes): A and V [cnt][cnt + 1], b and
// the coefficients [cnt]
__global__ void __launch_bounds__(kMaxRows)
solve(const double* __restrict__ sys, int cnt, int m, double* __restrict__ g) {
    extern __shared__ double smem[];
    const int ld = cnt + 1;
    double* A = smem;
    double* V = A + cnt * ld;
    double* bb = V + cnt * ld;
    double* coef = bb + cnt;
    __shared__ double rot[3];
    __shared__ int ok, rotated;
    const int t = threadIdx.x;
    if (t == 0) ok = 1;
    __syncthreads();
    if (t < cnt) {
        for (int j = 0; j < cnt; ++j) {
            const double v = sys[t * m + j];
            if (!isfinite(v)) ok = 0;
            A[t * ld + j] = 0.5 * (v + sys[j * m + t]);
            V[t * ld + j] = t == j ? 1.0 : 0.0;
        }
        bb[t] = sys[m * m + t];
        if (!isfinite(bb[t])) ok = 0;
    }
    __syncthreads();
    if (!ok || cnt == 0) {
        if (t < m) g[t] = 0.0;
        return;
    }
    for (int sweep = 0; sweep < 60; ++sweep) {
        if (t == 0) rotated = 0;
        __syncthreads();
        for (int p = 0; p < cnt - 1; ++p) {
            for (int q = p + 1; q < cnt; ++q) {
                if (t == 0) {
                    const double apq = A[p * ld + q], app = A[p * ld + p],
                                 aqq = A[q * ld + q];
                    const bool small =
                        fabs(apq) <= 1e-16 * sqrt(fabs(app) * fabs(aqq)) ||
                        apq == 0.0;
                    if (small) {
                        rot[0] = 1.0;
                        rot[1] = 0.0;
                        rot[2] = 0.0;  // no rotation
                    } else {
                        const double theta = (aqq - app) / (2.0 * apq);
                        const double tt =
                            fabs(theta) > 1e150
                                ? 0.5 / theta
                                : (theta >= 0.0 ? 1.0 : -1.0) /
                                      (fabs(theta) + sqrt(theta * theta + 1.0));
                        const double c = 1.0 / sqrt(tt * tt + 1.0);
                        rot[0] = c;
                        rot[1] = tt * c;
                        rot[2] = 1.0;
                        rotated = 1;
                    }
                }
                __syncthreads();
                if (rot[2] != 0.0) {
                    const double c = rot[0], s = rot[1];
                    if (t < cnt) {
                        const double akp = A[t * ld + p], akq = A[t * ld + q];
                        A[t * ld + p] = c * akp - s * akq;
                        A[t * ld + q] = s * akp + c * akq;
                        const double vkp = V[t * ld + p], vkq = V[t * ld + q];
                        V[t * ld + p] = c * vkp - s * vkq;
                        V[t * ld + q] = s * vkp + c * vkq;
                    }
                    __syncthreads();
                    if (t < cnt) {
                        const double apk = A[p * ld + t], aqk = A[q * ld + t];
                        A[p * ld + t] = c * apk - s * aqk;
                        A[q * ld + t] = s * apk + c * aqk;
                    }
                    __syncthreads();
                    if (t == 0) {
                        A[p * ld + q] = 0.0;
                        A[q * ld + p] = 0.0;
                    }
                    __syncthreads();
                }
            }
        }
        __syncthreads();
        if (!rotated) break;
        __syncthreads();
    }
    // the cut, then g = V (where(keep, 1/ew, 0) * (V^T b))
    double emax = A[0];
    for (int j = 1; j < cnt; ++j)
        emax = A[j * ld + j] > emax ? A[j * ld + j] : emax;
    const double thresh = 1e-12 * (emax > 0.0 ? emax : 0.0);
    if (t < cnt) {
        const double ew = A[t * ld + t];
        double vb = 0.0;
        for (int k = 0; k < cnt; ++k) vb += V[k * ld + t] * bb[k];
        coef[t] = ew > thresh ? (1.0 / ew) * vb : 0.0;
    }
    __syncthreads();
    if (t < cnt) {
        double s = 0.0;
        for (int j = 0; j < cnt; ++j) s += V[t * ld + j] * coef[j];
        g[t] = s;
    } else if (t < m) {
        g[t] = 0.0;
    }
}

inline size_t solve_smem(int cnt) {
    return sizeof(double) * (2 * (size_t)cnt * (cnt + 1) + 2 * (size_t)cnt);
}

// r z for a real r and a complex z as the plain version's complex product
// (r + 0i) z forms it: r x - 0 y, r y + 0 x, each rounded apart, so a NaN
// or infinity in one part spreads to both, as there
__device__ __forceinline__ double2 rmul(double r, double2 z) {
    return make_double2(__dsub_rn(__dmul_rn(r, z.x), __dmul_rn(0.0, z.y)),
                        __dadd_rn(__dmul_rn(r, z.y), __dmul_rn(0.0, z.x)));
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
    return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
    return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
}

__global__ void __launch_bounds__(kThreads)
update(const double2* __restrict__ x_in, const double2* __restrict__ x_new,
       const double2* __restrict__ hx, const double2* __restrict__ hf,
       const double* __restrict__ g, int cnt, int head, int m, long long nx,
       double beta, double2* __restrict__ x_out, int* __restrict__ flag) {
    __shared__ double s_g[kMaxRows];
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_g[i] = g[i];
    __syncthreads();
    int bad = 0;
    for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         x < nx; x += (long long)gridDim.x * blockDim.x) {
        const double2 xi = x_in[x], f = csub(x_new[x], xi);
        double2 sx = make_double2(0.0, 0.0), sf = make_double2(0.0, 0.0);
        for (int i = 0; i < cnt; ++i) {
            const long long off = (long long)slot_of(i, head, m) * nx + x;
            sx = cadd(sx, rmul(s_g[i], csub(xi, hx[off])));
            sf = cadd(sf, rmul(s_g[i], csub(f, hf[off])));
        }
        // x_opt + beta f_opt
        const double2 o = cadd(csub(xi, sx), rmul(beta, csub(f, sf)));
        if (!isfinite(o.x) || !isfinite(o.y)) bad = 1;
        x_out[x] = o;
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

__global__ void __launch_bounds__(kThreads)
finish(const double2* __restrict__ x_in, const double2* __restrict__ x_new,
       const double* __restrict__ eha_w, long long nx, long long ng,
       double beta, const int* __restrict__ flag, double2* __restrict__ x_out,
       double2* __restrict__ hx_slot, double2* __restrict__ hf_slot,
       double* __restrict__ partials) {
    __shared__ double red[kThreads];
    const bool fallback = *flag != 0;
    double s = 0.0;
    for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         x < nx; x += (long long)gridDim.x * blockDim.x) {
        const double2 xi = x_in[x], xn = x_new[x], f = csub(xn, xi);
        double2 o = x_out[x];
        if (fallback) {
            // the damped step x_in + beta f
            o = cadd(xi, rmul(beta, f));
            x_out[x] = o;
        }
        hx_slot[x] = xi;
        hf_slot[x] = f;
        if (x < ng) {
            const double dx = o.x - xn.x, dy = o.y - xn.y;
            s += eha_w[x] * (dx * dx + dy * dy);
        }
    }
    red[threadIdx.x] = s;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
        __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

__global__ void sum_partials(const double* __restrict__ partials, int n,
                             double* __restrict__ out) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
        double s = 0.0;
        for (int b = 0; b < n; ++b) s += partials[b];
        *out = s;
    }
}

}  // namespace

// scratch: the per-block partials, kMaxBlocks * (cnt (cnt + 1) / 2 + cnt + 1)
// doubles; out: a [m, m] (both triangles), b [m], rms [1]
extern "C" int mixer_gram(const void* x_in, const void* x_new, const void* hf,
                          const double* w, const double* rms_w, int cnt,
                          int head, int m, long long nx, double* scratch,
                          double* out, void* stream) {
    if (cnt < 0 || cnt > kMaxRows || cnt > m) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int nb = grid_for((nx + kTile - 1) / kTile, 4);
    gram_partials<<<nb, kThreads, 0, s>>>(
        (const double2*)x_in, (const double2*)x_new, (const double2*)hf, w,
        rms_w, cnt, head, m, nx, scratch);
    gram_reduce<<<1, kThreads, 0, s>>>(scratch, nb, cnt, m, out);
    return (int)cudaGetLastError();
}

// g: [m] doubles of scratch; flag: one int of scratch; partials: kMaxBlocks
// doubles of scratch; eha: [1]
extern "C" int mixer_update(const void* x_in, const void* x_new, void* hx,
                            void* hf, const double* sys, int cnt, int head,
                            int m, int push, long long nx, long long ng,
                            double beta, const double* eha_w, void* x_out,
                            double* g, int* flag, double* partials,
                            double* eha, void* stream) {
    if (cnt < 0 || cnt > kMaxRows || cnt > m || push < 0 || push >= m)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = solve_smem(cnt);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            solve, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    solve<<<1, kMaxRows, smem, s>>>(sys, cnt, m, g);
    cudaMemsetAsync(flag, 0, sizeof(int), s);
    const int nb = grid_for(nx, kThreads * 4);
    update<<<nb, kThreads, 0, s>>>(
        (const double2*)x_in, (const double2*)x_new, (const double2*)hx,
        (const double2*)hf, g, cnt, head, m, nx, beta, (double2*)x_out, flag);
    finish<<<nb, kThreads, 0, s>>>(
        (const double2*)x_in, (const double2*)x_new, eha_w, nx, ng, beta, flag,
        (double2*)x_out, (double2*)hx + (long long)push * nx,
        (double2*)hf + (long long)push * nx, partials);
    sum_partials<<<1, 32, 0, s>>>(partials, nb, eha);
    return (int)cudaGetLastError();
}
