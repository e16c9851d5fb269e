// K8: the Gamma packed-real layout around the two FFTs of the H application.
//
// Replaces the XLA fusions of sirius_tpu/ops/gamma.py::apply_h_s_gamma:
//   K8a unpack_to_box (:216-226): x * mask_p, the gathers through slot_re /
//       slot_im, c = scale * x[slot_re] + i * (scale * im_sign) * x[slot_im],
//       and the scatter-add of c into a zeroed box at fft_index;
//   K8b box_to_packed_hx (:230-245 with _pack_device :248-268): the gather
//       of v(G) back from the transformed box, the two-image average into
//       the packed real slots, hx = ekin_p * x + vpack, and the mask.
//
// Layout (one Gamma sphere of ngk lanes, P (G, -G) pairs): packed slot 0 is
// Re c(0), slots 1..P are sqrt2 Re c(G_rep), slots P+1..2P are sqrt2 Im
// c(G_rep), slots past 1+2P are padding (mask_p 0).
//
// Bound on the H100: bytes. K8a writes the whole [B, R, nbox] box (the zero
// fill is ~nbox/ngk = 28x the sphere's traffic), K8b reads 2P+1 box entries
// of each row and writes two real sphere rows; a few flops per element.
//
// Design: K8a is a zero fill (cudaMemsetAsync) then a scatter of the valid
// sphere lanes only.
// Padded lanes carry scale 0 and fft_index 0, which is the G = 0 slot: a
// plain store of every lane would clobber c(0), so lanes with scale 0 are
// skipped (valid indices are one-to-one: no atomics, deterministic). K8b is
// a pure gather, one thread per packed slot: the JAX package scatter-adds
// both pair members into each slot; here each slot reads its two box
// entries through the host-built tables rep_box / par_box and sums them,
// the same two products in a commutative sum, so no atomics and the same
// bits (the _rn intrinsics keep nvcc from contracting a product and a sum
// into one fused multiply-add, which rounds once instead of twice).
// Consecutive threads take consecutive packed slots, so x, hx and sx are
// read and written coalesced; the box reads are gathers.
//
// Each entry point comes in two instantiations of one template: float64
// packed blocks with complex128 boxes (the plain names) and float32 packed
// blocks with complex64 boxes and float32 tables (the *_f32 names, the fp32
// wave-function path of sirius_tpu/ops/gamma.py::make_gamma_params with
// rdtype float32; there _pack_device's sqrt2 / 2 is the float32 rounding of
// the same double). The fp32 ones move half the bytes with the same design.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and the function returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

// sqrt(2) / 2 rounded once: the same double as the JAX package's
// float(0.5 * np.sqrt(2.0)), and its float32 rounding
template <typename R>
__device__ __forceinline__ R half_sqrt2() {
    return R(0.70710678118654752440);
}

// x [rows, ngk] packed real -> box [rows, nbox]; the lane tables are [ngk].
template <typename R>
__global__ void unpack_scatter(const R* __restrict__ x,
                               const R* __restrict__ mask_p,
                               const int* __restrict__ slot_re,
                               const int* __restrict__ slot_im,
                               const R* __restrict__ im_sign,
                               const R* __restrict__ scale,
                               const int* __restrict__ fft_index,
                               cplx_t<R>* __restrict__ box, int ngk,
                               long long nbox, long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const R sc = scale[g];
        if (sc == R(0)) continue;  // padded lane
        const int a = slot_re[g];
        const int b = slot_im[g];
        const R xr = x[row * ngk + a] * mask_p[a];
        const R xi = x[row * ngk + b] * mask_p[b];
        box[row * nbox + fft_index[g]] =
            make_cplx<R>(sc * xr, (sc * im_sign[g]) * xi);
    }
}

// box [rows, nbox] -> hx, sx [rows, ngk] packed real.
template <typename R>
__global__ void pack_gather(const cplx_t<R>* __restrict__ box,
                            const R* __restrict__ x,
                            const R* __restrict__ ekin_p,
                            const R* __restrict__ mask_p,
                            const int* __restrict__ rep_box,
                            const int* __restrict__ par_box,
                            long long zero_box, int npair,
                            R* __restrict__ hx, R* __restrict__ sx,
                            int ngk, long long nbox, long long total) {
    const R h = half_sqrt2<R>();
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int p = (int)(t % ngk);
        const long long row = t / ngk;
        const cplx_t<R>* v = box + row * nbox;
        R vp = 0;
        if (p == 0) {
            vp = v[zero_box].x;
        } else if (p <= npair) {
            const int k = p - 1;
            vp = add_rn(mul_rn(h, v[rep_box[k]].x), mul_rn(h, v[par_box[k]].x));
        } else if (p <= 2 * npair) {
            const int k = p - 1 - npair;
            vp = sub_rn(mul_rn(h, v[rep_box[k]].y), mul_rn(h, v[par_box[k]].y));
        }
        const R m = mask_p[p];
        const R xm = x[t] * m;
        const R ek = m > R(0) ? ekin_p[p] : R(0);
        hx[t] = add_rn(mul_rn(ek, xm), vp) * m;
        sx[t] = xm * m;
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

template <typename R>
int unpack(const R* x, const R* mask_p, const int* slot_re, const int* slot_im,
           const R* im_sign, const R* scale, const int* fft_index, void* box,
           int nrows, int ngk, long long nbox, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nrows * nbox;
    // all-zero bits are a complex zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cplx_t<R>), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nrows * ngk;
    if (total > 0)
        unpack_scatter<R><<<grid_for(total, threads), threads, 0, s>>>(
            x, mask_p, slot_re, slot_im, im_sign, scale, fft_index,
            (cplx_t<R>*)box, ngk, nbox, total);
    return (int)cudaGetLastError();
}

template <typename R>
int pack(const void* box, const R* x, const R* ekin_p, const R* mask_p,
         const int* rep_box, const int* par_box, long long zero_box,
         int npair, R* hx, R* sx, int nrows, int ngk, long long nbox,
         void* stream) {
    const int threads = 256;
    const long long total = (long long)nrows * ngk;
    if (total > 0)
        pack_gather<R><<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
            (const cplx_t<R>*)box, x, ekin_p, mask_p, rep_box, par_box,
            zero_box, npair, hx, sx, ngk, nbox, total);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpack_to_box(const double* x, const double* mask_p,
                             const int* slot_re, const int* slot_im,
                             const double* im_sign, const double* scale,
                             const int* fft_index, void* box, int nrows,
                             int ngk, long long nbox, void* stream) {
    return unpack<double>(x, mask_p, slot_re, slot_im, im_sign, scale,
                          fft_index, box, nrows, ngk, nbox, stream);
}

extern "C" int unpack_to_box_f32(const float* x, const float* mask_p,
                                 const int* slot_re, const int* slot_im,
                                 const float* im_sign, const float* scale,
                                 const int* fft_index, void* box, int nrows,
                                 int ngk, long long nbox, void* stream) {
    return unpack<float>(x, mask_p, slot_re, slot_im, im_sign, scale,
                         fft_index, box, nrows, ngk, nbox, stream);
}

extern "C" int box_to_packed_hx(const void* box, const double* x,
                                const double* ekin_p, const double* mask_p,
                                const int* rep_box, const int* par_box,
                                long long zero_box, int npair, double* hx,
                                double* sx, int nrows, int ngk, long long nbox,
                                void* stream) {
    return pack<double>(box, x, ekin_p, mask_p, rep_box, par_box, zero_box,
                        npair, hx, sx, nrows, ngk, nbox, stream);
}

extern "C" int box_to_packed_hx_f32(const void* box, const float* x,
                                    const float* ekin_p, const float* mask_p,
                                    const int* rep_box, const int* par_box,
                                    long long zero_box, int npair, float* hx,
                                    float* sx, int nrows, int ngk,
                                    long long nbox, void* stream) {
    return pack<float>(box, x, ekin_p, mask_p, rep_box, par_box, zero_box,
                       npair, hx, sx, nrows, ngk, nbox, stream);
}
