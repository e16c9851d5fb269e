// K1c: the local potential applied in real space, in place.
//
// Replaces the XLA fusion of `fr * params.veff_r` between the two FFTs of
// sirius_tpu/ops/hamiltonian.py::apply_h_s (:79-82):
//   fr[b, r, i] *= veff[b % ns, i]
// with fr the complex128 inverse-FFT box [B, R, n] of a batch of (k, spin)
// blocks (b = ik * ns + ispn) and veff the float64 coarse-box potential
// [ns, n].
//
// Bound on the H100: bytes. Each element is read and written once (32
// bytes) for two multiplies; veff is re-read per row but a row of it
// (n * 8 bytes, <= 1.7 MB at a 60^3 box) stays in the 50 MB L2.
//
// Design: one grid-stride pass. blockIdx.y walks the rows (b, r), the x
// dimension walks the n points of a row, so neighbouring threads read
// neighbouring 16-byte elements of fr and 8-byte elements of veff (both
// coalesced) and no thread divides a 64-bit index. Elementwise: no sums,
// no atomics, bit-reproducible.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

__global__ void veff_multiply_kernel(cuDoubleComplex* __restrict__ fr,
                                     const double* __restrict__ veff,
                                     long long rows, int r_per_b, int ns,
                                     long long n) {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        const long long b = row / r_per_b;
        const double* v = veff + (b % ns) * n;
        cuDoubleComplex* f = fr + row * n;
        for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
             i < n; i += (long long)gridDim.x * blockDim.x) {
            const double s = v[i];
            cuDoubleComplex z = f[i];
            z.x *= s;
            z.y *= s;
            f[i] = z;
        }
    }
}

}  // namespace

extern "C" int veff_multiply(void* fr, const double* veff, int nbatch,
                             int r_per_b, int ns, long long n, void* stream) {
    const int threads = 256;
    const long long rows = (long long)nbatch * r_per_b;
    if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
    long long bx = (n + threads - 1) / threads;
    // enough blocks per row to fill the card at small row counts, a grid
    // stride beyond that
    if (bx > 1024) bx = 1024;
    const long long by = rows < 65535 ? rows : 65535;
    dim3 grid((unsigned)bx, (unsigned)by);
    veff_multiply_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (cuDoubleComplex*)fr, veff, rows, r_per_b, ns, n);
    return (int)cudaGetLastError();
}
