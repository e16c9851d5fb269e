// K11a / K11b: the sphere <-> box halves of the meta-GGA tau operator.
//
// The mGGA Kohn-Sham operator gains -1/2 div(v_tau grad .), applied per
// Cartesian component c as (H_tau psi)_G = 1/2 sum_c (G+k)_c
// FFT[v_tau(r) IFFT[(G+k)_c psi]]_G, and the kinetic-energy density needs
// IFFT[(G+k)_c psi] for every band.
//
// K11a (grad_to_box) replaces the scatter of sirius_tpu/ops/mgga.py::
// apply_h_s_mgga (:42-48) and tau_kset (:72-77): the box holding
// (G+k)_c psi(G) at fft_index and zero elsewhere. Padded G+k lanes all
// carry fft_index 0, which is also the G = 0 slot (the trap of K1): the
// zero fill is a cudaMemsetAsync and only valid lanes (mask > 0) are
// stored. Valid indices are one-to-one, so no atomics and the result is
// deterministic.
//
// K11b (box_to_pw_tau) replaces the gather and the sum of apply_h_s_mgga
// (:50-55): back_c = box[fft_index] after the forward FFT, added straight
// into hpsi, hpsi += (0.5 (G+k)_c back_c) mask, once per component. The
// JAX package sums the three components first (acc, then
// hpsi + 0.5 acc mask); adding them one at a time rounds differently, by
// an ulp of hpsi, and needs no acc buffer. One thread per (row, lane), no
// atomics; products and sums use the rounded mul_rn / add_rn of
// precision.cuh, so the compiler
// cannot fuse them and the results are the plain version's bits.
//
// Bound on the H100: bytes. K11a writes the whole complex box (16 bytes a
// box point; the box is ~27x the sphere at the production decks, so the
// fill dominates) and reads 16 + 8 + 4 + 8 bytes a lane; K11b reads the
// box at the lanes (a gather) and reads and writes 16 bytes of hpsi a
// lane.
//
// Each entry point comes in two instantiations of one template: complex128
// blocks with float64 G+k vectors and mask (the plain names) and complex64
// blocks with float32 ones (the *_c64 names, the fp32 wave-function path of
// sirius_tpu/dft/scf.py::_gkc_dev(float32)). The fp32 ones move half the
// bytes with the same design.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and each function returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

// psi [nbatch, nrows, ngk] -> box [nbatch, nrows, nbox]; fft_index / mask
// [nbatch, ngk] and gkc [nbatch, ngk, 3] when index_batched, else [ngk] and
// [ngk, 3]
template <typename R>
__global__ void grad_scatter(const cplx_t<R>* __restrict__ psi,
                             const R* __restrict__ gkc, int comp,
                             const int* __restrict__ fft_index,
                             const R* __restrict__ mask,
                             cplx_t<R>* __restrict__ box, int nrows,
                             int ngk, long long nbox, int index_batched,
                             long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;  // b * nrows + band
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        if (!(mask[lane] > R(0))) continue;
        const R gc = gkc[3 * lane + comp];
        const cplx_t<R> p = psi[t];
        box[row * nbox + fft_index[lane]] =
            make_cplx<R>(mul_rn(gc, p.x), mul_rn(gc, p.y));
    }
}

// hpsi += (0.5 gc back) m
template <typename R>
__global__ void grad_gather(const cplx_t<R>* __restrict__ box,
                            const R* __restrict__ gkc, int comp,
                            const int* __restrict__ fft_index,
                            const R* __restrict__ mask,
                            cplx_t<R>* __restrict__ hpsi, int nrows,
                            int ngk, long long nbox, int index_batched,
                            long long total) {
    const R half = R(0.5);
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        const R gc = gkc[3 * lane + comp];
        const R m = mask[lane];
        const cplx_t<R> v = box[row * nbox + fft_index[lane]];
        const cplx_t<R> h = hpsi[t];
        hpsi[t] = make_cplx<R>(
            add_rn(h.x, mul_rn(mul_rn(half, mul_rn(gc, v.x)), m)),
            add_rn(h.y, mul_rn(mul_rn(half, mul_rn(gc, v.y)), m)));
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

template <typename R>
int scatter(const void* psi, const R* gkc, int comp, const int* fft_index,
            const R* mask, void* box, int nbatch, int nrows, int ngk,
            long long nbox, int index_batched, void* stream) {
    if (comp < 0 || comp > 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nbatch * nrows * nbox;
    // all-zero bits are a complex zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cplx_t<R>), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        grad_scatter<R><<<grid_for(total, threads), threads, 0, s>>>(
            (const cplx_t<R>*)psi, gkc, comp, fft_index, mask,
            (cplx_t<R>*)box, nrows, ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}

template <typename R>
int gather(const void* box, const R* gkc, int comp, const int* fft_index,
           const R* mask, void* hpsi, int nbatch, int nrows, int ngk,
           long long nbox, int index_batched, void* stream) {
    if (comp < 0 || comp > 2) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        grad_gather<R><<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
            (const cplx_t<R>*)box, gkc, comp, fft_index, mask,
            (cplx_t<R>*)hpsi, nrows, ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grad_to_box(const void* psi, const double* gkc, int comp,
                           const int* fft_index, const double* mask, void* box,
                           int nbatch, int nrows, int ngk, long long nbox,
                           int index_batched, void* stream) {
    return scatter<double>(psi, gkc, comp, fft_index, mask, box, nbatch, nrows,
                           ngk, nbox, index_batched, stream);
}

extern "C" int grad_to_box_c64(const void* psi, const float* gkc, int comp,
                               const int* fft_index, const float* mask,
                               void* box, int nbatch, int nrows, int ngk,
                               long long nbox, int index_batched,
                               void* stream) {
    return scatter<float>(psi, gkc, comp, fft_index, mask, box, nbatch, nrows,
                          ngk, nbox, index_batched, stream);
}

extern "C" int box_to_pw_tau(const void* box, const double* gkc, int comp,
                             const int* fft_index, const double* mask,
                             void* hpsi, int nbatch, int nrows,
                             int ngk, long long nbox, int index_batched,
                             void* stream) {
    return gather<double>(box, gkc, comp, fft_index, mask, hpsi, nbatch, nrows,
                          ngk, nbox, index_batched, stream);
}

extern "C" int box_to_pw_tau_c64(const void* box, const float* gkc, int comp,
                                 const int* fft_index, const float* mask,
                                 void* hpsi, int nbatch, int nrows, int ngk,
                                 long long nbox, int index_batched,
                                 void* stream) {
    return gather<float>(box, gkc, comp, fft_index, mask, hpsi, nbatch, nrows,
                         ngk, nbox, index_batched, stream);
}
