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
// atomics; products and sums use __dmul_rn / __dadd_rn, so the compiler
// cannot fuse them and the results are the plain version's bits.
//
// Bound on the H100: bytes. K11a writes the whole complex box (16 bytes a
// box point; the box is ~27x the sphere at the production decks, so the
// fill dominates) and reads 16 + 8 + 4 + 8 bytes a lane; K11b reads the
// box at the lanes (a gather) and reads and writes 16 bytes of hpsi a
// lane.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and each function returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

// psi [nbatch, nrows, ngk] -> box [nbatch, nrows, nbox]; fft_index / mask
// [nbatch, ngk] and gkc [nbatch, ngk, 3] when index_batched, else [ngk] and
// [ngk, 3]
__global__ void grad_scatter(const cuDoubleComplex* __restrict__ psi,
                             const double* __restrict__ gkc, int comp,
                             const int* __restrict__ fft_index,
                             const double* __restrict__ mask,
                             cuDoubleComplex* __restrict__ box, int nrows,
                             int ngk, long long nbox, int index_batched,
                             long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;  // b * nrows + band
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        if (!(mask[lane] > 0.0)) continue;
        const double gc = gkc[3 * lane + comp];
        const cuDoubleComplex p = psi[t];
        box[row * nbox + fft_index[lane]] =
            make_cuDoubleComplex(__dmul_rn(gc, p.x), __dmul_rn(gc, p.y));
    }
}

// hpsi += (0.5 gc back) m
__global__ void grad_gather(const cuDoubleComplex* __restrict__ box,
                            const double* __restrict__ gkc, int comp,
                            const int* __restrict__ fft_index,
                            const double* __restrict__ mask,
                            cuDoubleComplex* __restrict__ hpsi, int nrows,
                            int ngk, long long nbox, int index_batched,
                            long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        const double gc = gkc[3 * lane + comp];
        const double m = mask[lane];
        const cuDoubleComplex v = box[row * nbox + fft_index[lane]];
        const cuDoubleComplex h = hpsi[t];
        hpsi[t] = make_cuDoubleComplex(
            __dadd_rn(h.x, __dmul_rn(__dmul_rn(0.5, __dmul_rn(gc, v.x)), m)),
            __dadd_rn(h.y, __dmul_rn(__dmul_rn(0.5, __dmul_rn(gc, v.y)), m)));
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

}  // namespace

extern "C" int grad_to_box(const void* psi, const double* gkc, int comp,
                           const int* fft_index, const double* mask, void* box,
                           int nbatch, int nrows, int ngk, long long nbox,
                           int index_batched, void* stream) {
    if (comp < 0 || comp > 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nbatch * nrows * nbox;
    // all-zero bits are a complex128 zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cuDoubleComplex), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        grad_scatter<<<grid_for(total, threads), threads, 0, s>>>(
            (const cuDoubleComplex*)psi, gkc, comp, fft_index, mask,
            (cuDoubleComplex*)box, nrows, ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}

extern "C" int box_to_pw_tau(const void* box, const double* gkc, int comp,
                             const int* fft_index, const double* mask,
                             void* hpsi, int nbatch, int nrows,
                             int ngk, long long nbox, int index_batched,
                             void* stream) {
    if (comp < 0 || comp > 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        grad_gather<<<grid_for(total, threads), threads, 0, s>>>(
            (const cuDoubleComplex*)box, gkc, comp, fft_index, mask,
            (cuDoubleComplex*)hpsi, nrows, ngk, nbox,
            index_batched, total);
    return (int)cudaGetLastError();
}
