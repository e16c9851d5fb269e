// K16: the density's coarse box and its scatter onto the fine G set, the
// two passes around the forward FFT of dft/density.py::
// density_from_coarse_acc.
//
// Replaces the XLA fusions of sirius_tpu/dft/fused.py::_step_impl
// (:311-318; the host loop's sirius_tpu/dft/density.py::
// density_from_coarse_acc): acc / Omega cast to complex128, the sphere
// gather of the transformed box (fft_index_coarse) and the zero fill of
// [ns, ng] with the coarse -> fine scatter (c2f).
//   K16a coarse_box:   box[i] = (acc[i] * (1 / Omega), 0), complex128
//   K16b scatter_fine: out[s, j] = t[j] >= 0 ? boxg[s, t[j]] : 0
// where t (built once on the host, dft/density.py::grid_tables) holds for
// every fine G the coarse box slot of the same G, or -1 where the G lies
// outside the coarse sphere: the gather and the scatter in one table, so
// every fine slot is written once, with no zero-fill pass and no atomics.
//
// Bits: those of the plain PyTorch version on the card. There acc / Omega
// by a host scalar runs as acc * (1 / Omega), and the gather and the
// scatter are exact copies; K16a multiplies the same way and K16b
// copies.
//
// Bound on the H100: bytes. K16a reads ns * nbox accumulations and writes
// ns * nbox complex values; K16b reads ng indices and at most ns * ngc
// complex values and writes ns * ng. One thread an element, consecutive
// threads on consecutive elements (K16b's reads are gathers, its writes
// coalesced).
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void coarse_box_kernel(const double* __restrict__ acc,
                                  double inv, long long n,
                                  double2* __restrict__ box) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        box[i] = make_double2(acc[i] * inv, 0.0);
    }
}

__global__ void scatter_fine_kernel(const double2* __restrict__ boxg,
                                    const int* __restrict__ table, int ns,
                                    long long nbox, long long ng,
                                    double2* __restrict__ out) {
    const long long n = ns * ng;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const long long s = i / ng;
        const int t = table[i - s * ng];
        out[i] = t >= 0 ? boxg[s * nbox + t] : make_double2(0.0, 0.0);
    }
}

int blocks_for(long long n) {
    long long b = (n + kThreads - 1) / kThreads;
    if (b > 65535LL * 32) b = 65535LL * 32;
    return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

// acc [n] float64, inv = 1 / Omega; box [n] complex128
extern "C" int coarse_box(const void* acc, double inv, long long n,
                          void* box, void* stream) {
    coarse_box_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)acc, inv, n, (double2*)box);
    return (int)cudaGetLastError();
}

// boxg [ns, nbox] complex128, table [ng] int32; out [ns, ng] complex128
extern "C" int scatter_fine(const void* boxg, const void* table, int ns,
                            long long nbox, long long ng, void* out,
                            void* stream) {
    scatter_fine_kernel<<<blocks_for(ns * ng), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const double2*)boxg, (const int*)table, ns, nbox, ng,
        (double2*)out);
    return (int)cudaGetLastError();
}
