// K1: the local part of H*psi around the two batched 3-D FFTs.
//
// Replaces the XLA fusions of sirius_tpu/ops/hamiltonian.py::apply_h_s
// (:72-86): psi*mask scattered into the FFT box, and the gather back from
// the box fused with ekin*psi, the mask and S*psi. The same two entry
// points serve core/fftgrid.py::g_to_r / r_to_g (:125-154) and the
// sphere->box step of parallel/batched.py::density_kset (:341).
//
// Bound on the H100: bytes. Each element is touched once with a few flops,
// so both entry points are limited by device memory (3.35 TB/s). The box
// is N/ngk (~27x at the production decks) larger than the sphere, so the
// zero fill of pw_to_box dominates its traffic.
//
// Design: pw_to_box is a zero fill (cudaMemsetAsync) then a scatter of the
// valid lanes only.
// Padded G+k lanes all carry fft_index 0, which is also the G = 0 slot: a
// plain store of every lane would clobber psi(G=0), so masked lanes are
// skipped instead (valid indices are one-to-one: no atomics, deterministic).
// box_to_pw is one pass over the sphere: consecutive threads take
// consecutive G+k lanes, so psi/ekin/mask/hpsi/spsi are read and written
// coalesced; the box read is a gather.
//
// Two instantiations of one template: complex128 blocks with float64
// ekin / mask (pw_to_box, box_to_pw) and complex64 blocks with float32
// ekin / mask (pw_to_box_c64, box_to_pw_c64), the fp32 wave-function path
// of sirius_tpu/ops/hamiltonian.py::make_hk_params(dtype=complex64). The
// fp32 one moves half the bytes with the same design.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and the function returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

// psi [nbatch, nrows, ngk] -> box [nbatch, nrows, nbox]; fft_index / mask
// are [nbatch, ngk] when index_batched, else [ngk]; mask may be null.
template <typename R>
__global__ void scatter_valid(const cplx_t<R>* __restrict__ psi,
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
        if (mask != nullptr && !(mask[lane] > R(0))) continue;
        box[row * nbox + fft_index[lane]] = psi[t];
    }
}

// hpsi = m * (where(m > 0, ekin, 0) * psi + box[fft_index]),  spsi = m * psi.
// With psi == null it is the plain gather hpsi = m * box[fft_index].
template <typename R>
__global__ void gather_hpsi(const cplx_t<R>* __restrict__ box,
                            const cplx_t<R>* __restrict__ psi,
                            const R* __restrict__ ekin,
                            const R* __restrict__ mask,
                            const int* __restrict__ fft_index,
                            cplx_t<R>* __restrict__ hpsi,
                            cplx_t<R>* __restrict__ spsi, int nrows,
                            int ngk, long long nbox, int index_batched,
                            long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        const R m = mask != nullptr ? mask[lane] : R(1);
        const cplx_t<R> v = box[row * nbox + fft_index[lane]];
        R hr = v.x, hi = v.y;
        if (psi != nullptr) {
            const cplx_t<R> p = psi[t];
            const R ek = m > R(0) ? ekin[lane] : R(0);
            hr = ek * p.x + v.x;
            hi = ek * p.y + v.y;
            if (spsi != nullptr) spsi[t] = make_cplx<R>(m * p.x, m * p.y);
        }
        hpsi[t] = make_cplx<R>(m * hr, m * hi);
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

template <typename R>
int scatter(const void* psi, const int* fft_index, const R* mask, void* box,
            int nbatch, int nrows, int ngk, long long nbox, int index_batched,
            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nbatch * nrows * nbox;
    // all-zero bits are a complex zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cplx_t<R>), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        scatter_valid<R><<<grid_for(total, threads), threads, 0, s>>>(
            (const cplx_t<R>*)psi, fft_index, mask, (cplx_t<R>*)box, nrows,
            ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}

template <typename R>
int gather(const void* box, const void* psi, const R* ekin, const R* mask,
           const int* fft_index, void* hpsi, void* spsi, int nbatch, int nrows,
           int ngk, long long nbox, int index_batched, void* stream) {
    const int threads = 256;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        gather_hpsi<R><<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
            (const cplx_t<R>*)box, (const cplx_t<R>*)psi, ekin, mask,
            fft_index, (cplx_t<R>*)hpsi, (cplx_t<R>*)spsi, nrows, ngk, nbox,
            index_batched, total);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pw_to_box(const void* psi, const int* fft_index,
                         const double* mask, void* box, int nbatch, int nrows,
                         int ngk, long long nbox, int index_batched,
                         void* stream) {
    return scatter<double>(psi, fft_index, mask, box, nbatch, nrows, ngk, nbox,
                           index_batched, stream);
}

extern "C" int pw_to_box_c64(const void* psi, const int* fft_index,
                             const float* mask, void* box, int nbatch,
                             int nrows, int ngk, long long nbox,
                             int index_batched, void* stream) {
    return scatter<float>(psi, fft_index, mask, box, nbatch, nrows, ngk, nbox,
                          index_batched, stream);
}

extern "C" int box_to_pw(const void* box, const void* psi, const double* ekin,
                         const double* mask, const int* fft_index, void* hpsi,
                         void* spsi, int nbatch, int nrows, int ngk,
                         long long nbox, int index_batched, void* stream) {
    return gather<double>(box, psi, ekin, mask, fft_index, hpsi, spsi, nbatch,
                          nrows, ngk, nbox, index_batched, stream);
}

extern "C" int box_to_pw_c64(const void* box, const void* psi,
                             const float* ekin, const float* mask,
                             const int* fft_index, void* hpsi, void* spsi,
                             int nbatch, int nrows, int ngk, long long nbox,
                             int index_batched, void* stream) {
    return gather<float>(box, psi, ekin, mask, fft_index, hpsi, spsi, nbatch,
                         nrows, ngk, nbox, index_batched, stream);
}
