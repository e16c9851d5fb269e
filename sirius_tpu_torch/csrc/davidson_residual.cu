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
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

constexpr int kThreads = 256;

// element access: a real element is a complex one with imaginary part 0
__device__ inline double2 load(const cuDoubleComplex* p, long long i) {
    const cuDoubleComplex z = p[i];
    return make_double2(z.x, z.y);
}
__device__ inline double2 load(const double* p, long long i) {
    return make_double2(p[i], 0.0);
}
__device__ inline void store(cuDoubleComplex* p, long long i, double re,
                             double im) {
    p[i] = make_cuDoubleComplex(re, im);
}
__device__ inline void store(double* p, long long i, double re, double) {
    p[i] = re;
}

__device__ double block_sum(double v, double* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const double out = sh[0];
    __syncthreads();
    return out;
}

// x, hx, sx, w: [nrows_total, ngk]; h_diag, o_diag, mask: [nrows_total/nb, ngk].
// mask may be null (exit values: no mask, as davidson.py:209-213); w may be
// null (exit values: no preconditioned block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_rows(const T* __restrict__ x, const T* __restrict__ hx,
              const T* __restrict__ sx,
              const double* __restrict__ h_diag,
              const double* __restrict__ o_diag,
              const double* __restrict__ mask, double res_tol,
              double* __restrict__ evals, double* __restrict__ rnorm,
              T* __restrict__ w, int nb, int ngk) {
    __shared__ double sh[kThreads];
    const long long row = blockIdx.x;
    const long long off = row * (long long)ngk;
    const long long doff = (row / nb) * (long long)ngk;

    double num = 0.0, den = 0.0;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const double2 xv = load(x, off + g);
        const double2 hv = load(hx, off + g);
        const double2 sv = load(sx, off + g);
        num += xv.x * hv.x + xv.y * hv.y;  // Re(conj(x) * hx)
        den += xv.x * sv.x + xv.y * sv.y;
    }
    num = block_sum(num, sh);
    den = block_sum(den, sh);
    const double ev = num / (fabs(den) > 1e-30 ? den : 1.0);

    double r2 = 0.0;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const double m = mask != nullptr ? mask[doff + g] : 1.0;
        const double2 hv = load(hx, off + g);
        const double2 sv = load(sx, off + g);
        const double rr = (hv.x - ev * sv.x) * m;
        const double ri = (hv.y - ev * sv.y) * m;
        r2 += rr * rr + ri * ri;
    }
    r2 = block_sum(r2, sh);
    const double rn = sqrt(r2);
    if (threadIdx.x == 0) {
        evals[row] = ev;
        rnorm[row] = rn;
    }
    if (w == nullptr) return;

    const bool conv = rn < res_tol;
    for (int g = threadIdx.x; g < ngk; g += kThreads) {
        const double m = mask != nullptr ? mask[doff + g] : 1.0;
        double wr = 0.0, wi = 0.0;
        if (!conv) {
            const double2 hv = load(hx, off + g);
            const double2 sv = load(sx, off + g);
            double p = h_diag[doff + g] - ev * o_diag[doff + g];
            p = 0.5 * (1.0 + p + sqrt(1.0 + (p - 1.0) * (p - 1.0)));
            wr = (hv.x - ev * sv.x) * m / p;
            wi = (hv.y - ev * sv.y) * m / p;
        }
        store(w, off + g, wr * m, wi * m);
    }
}

template <typename T>
int launch(const void* x, const void* hx, const void* sx, const double* h_diag,
           const double* o_diag, const double* mask, double res_tol,
           double* evals, double* rnorm, void* w, int nrows_total, int nb,
           int ngk, void* stream) {
    if (nrows_total > 0)
        residual_rows<T><<<nrows_total, kThreads, 0, (cudaStream_t)stream>>>(
            (const T*)x, (const T*)hx, (const T*)sx, h_diag, o_diag, mask,
            res_tol, evals, rnorm, (T*)w, nb, ngk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int davidson_residual(const void* x, const void* hx, const void* sx,
                                 const double* h_diag, const double* o_diag,
                                 const double* mask, double res_tol,
                                 double* evals, double* rnorm, void* w,
                                 int nrows_total, int nb, int ngk,
                                 void* stream) {
    return launch<cuDoubleComplex>(x, hx, sx, h_diag, o_diag, mask, res_tol,
                                   evals, rnorm, w, nrows_total, nb, ngk,
                                   stream);
}

extern "C" int davidson_residual_f64(const void* x, const void* hx,
                                     const void* sx, const double* h_diag,
                                     const double* o_diag, const double* mask,
                                     double res_tol, double* evals,
                                     double* rnorm, void* w, int nrows_total,
                                     int nb, int ngk, void* stream) {
    return launch<double>(x, hx, sx, h_diag, o_diag, mask, res_tol, evals,
                          rnorm, w, nrows_total, nb, ngk, stream);
}
