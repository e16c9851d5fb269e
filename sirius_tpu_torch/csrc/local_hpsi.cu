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
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and the function returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

// psi [nbatch, nrows, ngk] -> box [nbatch, nrows, nbox]; fft_index / mask
// are [nbatch, ngk] when index_batched, else [ngk]; mask may be null.
__global__ void scatter_valid(const cuDoubleComplex* __restrict__ psi,
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
        if (mask != nullptr && !(mask[lane] > 0.0)) continue;
        box[row * nbox + fft_index[lane]] = psi[t];
    }
}

// hpsi = m * (where(m > 0, ekin, 0) * psi + box[fft_index]),  spsi = m * psi.
// With psi == null it is the plain gather hpsi = m * box[fft_index].
__global__ void gather_hpsi(const cuDoubleComplex* __restrict__ box,
                            const cuDoubleComplex* __restrict__ psi,
                            const double* __restrict__ ekin,
                            const double* __restrict__ mask,
                            const int* __restrict__ fft_index,
                            cuDoubleComplex* __restrict__ hpsi,
                            cuDoubleComplex* __restrict__ spsi, int nrows,
                            int ngk, long long nbox, int index_batched,
                            long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const long long b = row / nrows;
        const long long lane = (index_batched ? b * ngk : 0) + g;
        const double m = mask != nullptr ? mask[lane] : 1.0;
        const cuDoubleComplex v = box[row * nbox + fft_index[lane]];
        double hr = v.x, hi = v.y;
        if (psi != nullptr) {
            const cuDoubleComplex p = psi[t];
            const double ek = m > 0.0 ? ekin[lane] : 0.0;
            hr = ek * p.x + v.x;
            hi = ek * p.y + v.y;
            if (spsi != nullptr) spsi[t] = make_cuDoubleComplex(m * p.x, m * p.y);
        }
        hpsi[t] = make_cuDoubleComplex(m * hr, m * hi);
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

}  // namespace

extern "C" int pw_to_box(const void* psi, const int* fft_index,
                         const double* mask, void* box, int nbatch, int nrows,
                         int ngk, long long nbox, int index_batched,
                         void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nbatch * nrows * nbox;
    // all-zero bits are a complex128 zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cuDoubleComplex), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        scatter_valid<<<grid_for(total, threads), threads, 0, s>>>(
            (const cuDoubleComplex*)psi, fft_index, mask,
            (cuDoubleComplex*)box, nrows, ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}

extern "C" int box_to_pw(const void* box, const void* psi, const double* ekin,
                         const double* mask, const int* fft_index, void* hpsi,
                         void* spsi, int nbatch, int nrows, int ngk,
                         long long nbox, int index_batched, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long total = (long long)nbatch * nrows * ngk;
    if (total > 0)
        gather_hpsi<<<grid_for(total, threads), threads, 0, s>>>(
            (const cuDoubleComplex*)box, (const cuDoubleComplex*)psi, ekin,
            mask, fft_index, (cuDoubleComplex*)hpsi, (cuDoubleComplex*)spsi,
            nrows, ngk, nbox, index_batched, total);
    return (int)cudaGetLastError();
}
