// K9: one atom chunk of beta projectors, generated on the fly.
//
// Replaces the XLA fusion that builds beta_c inside the lax.scan step of
// sirius_tpu/ops/beta_chunked.py::apply_h_s_chunked (:279-301; the same
// step of chunked_nonlocal :144-170), the TPU form of the reference's
// create_beta_gk.cu:
//
//   beta[c, xi, g] = pref * cph[c, xi] * rlm[g, lm[c, xi]]
//                    * lerp(ri_grid[rf[c, xi]], q[g] / dq) * mask[g]
//                    * exp(-2 pi i mk[g] . pos[c])
//
// with the JAX package's interpolation exactly: iq = clip(q / dq, 0,
// NQ - 1.001), i0 = (int) iq, t = iq - i0, ri = ri_grid[rf, i0] (1 - t) +
// ri_grid[rf, i0 + 1] t. Padded xi slots and padded atoms carry cph = 0
// and give exact zeros. The GEMMs around the chunk stay cuBLAS.
//
// Bound on the H100: bytes. The output [C, nxi, ngk] complex128 (16 bytes
// an element) is written once; the inputs per G (q, mask, mk, one rlm row)
// are ~48 + 8 lmmax bytes shared by the C * nxi outputs of that G, and the
// radial rows (a few KB) stay in L1/L2. About 12 flops per element plus
// one sincospi per (atom, G).
//
// Design: one thread per (atom, G), G fastest, so every store of the nxi
// loop is coalesced. The phase (sincospi of 2 mk.pos, exact argument
// reduction, no [ngk, C] phase table) and the interpolation weights are
// computed once per thread and reused for the atom's nxi projectors.
// Elementwise: no sums across threads, no atomics, deterministic.
//
// Two instantiations of one template: complex128 projectors from float64
// tables (beta_chunk) and complex64 projectors from float32 tables
// (beta_chunk_c64), the fp32 wave-function path of
// sirius_tpu/ops/beta_chunked.py::make_chunked_hk(dtype=complex64), whose
// tables, dq and pref are float32: the interpolation index, weights and
// phase are then computed in float32 (sincospif), and the output bytes
// halve.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

template <typename R>
__global__ void beta_chunk_kernel(cplx_t<R>* __restrict__ beta,
                                  const R* __restrict__ pos,
                                  const int* __restrict__ xi_rf,
                                  const int* __restrict__ xi_lm,
                                  const cplx_t<R>* __restrict__ cph,
                                  const R* __restrict__ rlm,
                                  const R* __restrict__ q,
                                  const R* __restrict__ mk,
                                  const R* __restrict__ mask,
                                  const R* __restrict__ ri_grid,
                                  int nxi, int ngk, int lmmax, int nq,
                                  R dq, R pref, R clip_hi) {
    const int c = blockIdx.y;
    const R px = pos[3 * c], py = pos[3 * c + 1], pz = pos[3 * c + 2];
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < ngk;
         g += gridDim.x * blockDim.x) {
        // e^{-2 pi i x} = cos(2 pi x) - i sin(2 pi x)
        const R x = mk[3 * g] * px + mk[3 * g + 1] * py + mk[3 * g + 2] * pz;
        R s, co;
        sincospi_(R(2) * x, &s, &co);
        const R ph_re = co, ph_im = -s;
        const R iq = fmin(fmax(q[g] / dq, R(0)), clip_hi);
        const int i0 = (int)iq;
        const R t = iq - (R)i0;
        const R m = mask != nullptr ? mask[g] : R(1);
        for (int xi = 0; xi < nxi; ++xi) {
            const int k = c * nxi + xi;
            const R* row = ri_grid + (long long)xi_rf[k] * nq;
            const R ri = (row[i0] * (R(1) - t) + row[i0 + 1] * t) * m;
            const R ang = rlm[(long long)g * lmmax + xi_lm[k]];
            const cplx_t<R> cp = cph[k];
            const R a = pref * cp.x * ang * ri;
            const R b = pref * cp.y * ang * ri;
            beta[(long long)k * ngk + g] =
                make_cplx<R>(a * ph_re - b * ph_im, a * ph_im + b * ph_re);
        }
    }
}

template <typename R>
int launch(void* beta, const R* pos, const int* xi_rf, const int* xi_lm,
           const void* cph, const R* rlm, const R* q, const R* mk,
           const R* mask, const R* ri_grid, int natoms, int nxi, int ngk,
           int lmmax, int nq, double dq, double pref, double clip_hi,
           void* stream) {
    const int threads = 256;
    if (natoms <= 0 || nxi <= 0 || ngk <= 0) return (int)cudaGetLastError();
    const int bx = (ngk + threads - 1) / threads;
    dim3 grid((unsigned)bx, (unsigned)natoms);
    beta_chunk_kernel<R><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (cplx_t<R>*)beta, pos, xi_rf, xi_lm, (const cplx_t<R>*)cph, rlm, q,
        mk, mask, ri_grid, nxi, ngk, lmmax, nq, (R)dq, (R)pref, (R)clip_hi);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int beta_chunk(void* beta, const double* pos, const int* xi_rf,
                          const int* xi_lm, const void* cph, const double* rlm,
                          const double* q, const double* mk, const double* mask,
                          const double* ri_grid, int natoms, int nxi, int ngk,
                          int lmmax, int nq, double dq, double pref,
                          double clip_hi, void* stream) {
    return launch<double>(beta, pos, xi_rf, xi_lm, cph, rlm, q, mk, mask,
                          ri_grid, natoms, nxi, ngk, lmmax, nq, dq, pref,
                          clip_hi, stream);
}

extern "C" int beta_chunk_c64(void* beta, const float* pos, const int* xi_rf,
                              const int* xi_lm, const void* cph,
                              const float* rlm, const float* q,
                              const float* mk, const float* mask,
                              const float* ri_grid, int natoms, int nxi,
                              int ngk, int lmmax, int nq, double dq,
                              double pref, double clip_hi, void* stream) {
    return launch<float>(beta, pos, xi_rf, xi_lm, cph, rlm, q, mk, mask,
                         ri_grid, natoms, nxi, ngk, lmmax, nq, dq, pref,
                         clip_hi, stream);
}
