// K1c: the local potential applied in real space, in place.
//
// Replaces the XLA fusion of `fr * params.veff_r` between the two FFTs of
// sirius_tpu/ops/hamiltonian.py::apply_h_s (:79-82):
//   fr[b, r, i] *= veff[b % ns, i]
// with fr the complex128 inverse-FFT box [B, R, n] of a batch of (k, spin)
// blocks (b = ik * ns + ispn) and veff the float64 coarse-box potential
// [ns, n].
//
// Real mode (veff_multiply_real) replaces `jnp.real(fr) * params.veff_r`
// of sirius_tpu/ops/gamma.py::apply_h_s_gamma (:230-233): at Gamma the box
// holds a Hermitian-symmetric field, so its rounding-level imaginary part
// is dropped BEFORE the multiply, fr[b, r, i] = Re(fr[b, r, i]) * veff + 0i.
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
// Both modes come in two instantiations of one template: complex128 boxes
// with a float64 potential, and complex64 boxes with a float32 potential
// (the *_c64 entry points, the fp32 wave-function path of
// sirius_tpu/ops/hamiltonian.py and ops/gamma.py with real_dtype_of
// float32). The fp32 one moves half the bytes with the same design.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

template <typename R, bool kRealMode>
__global__ void veff_multiply_kernel(cplx_t<R>* __restrict__ fr,
                                     const R* __restrict__ veff,
                                     long long rows, int r_per_b, int ns,
                                     long long n) {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        const long long b = row / r_per_b;
        const R* v = veff + (b % ns) * n;
        cplx_t<R>* f = fr + row * n;
        for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
             i < n; i += (long long)gridDim.x * blockDim.x) {
            const R s = v[i];
            cplx_t<R> z = f[i];
            z.x *= s;
            z.y = kRealMode ? R(0) : z.y * s;
            f[i] = z;
        }
    }
}

template <typename R, bool kRealMode>
int launch(void* fr, const R* veff, int nbatch, int r_per_b, int ns,
           long long n, void* stream) {
    const int threads = 256;
    const long long rows = (long long)nbatch * r_per_b;
    if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
    long long bx = (n + threads - 1) / threads;
    // enough blocks per row to fill the card at small row counts, a grid
    // stride beyond that
    if (bx > 1024) bx = 1024;
    const long long by = rows < 65535 ? rows : 65535;
    dim3 grid((unsigned)bx, (unsigned)by);
    veff_multiply_kernel<R, kRealMode>
        <<<grid, threads, 0, (cudaStream_t)stream>>>((cplx_t<R>*)fr, veff,
                                                     rows, r_per_b, ns, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int veff_multiply(void* fr, const double* veff, int nbatch,
                             int r_per_b, int ns, long long n, void* stream) {
    return launch<double, false>(fr, veff, nbatch, r_per_b, ns, n, stream);
}

extern "C" int veff_multiply_real(void* fr, const double* veff, int nbatch,
                                  int r_per_b, int ns, long long n,
                                  void* stream) {
    return launch<double, true>(fr, veff, nbatch, r_per_b, ns, n, stream);
}

extern "C" int veff_multiply_c64(void* fr, const float* veff, int nbatch,
                                 int r_per_b, int ns, long long n,
                                 void* stream) {
    return launch<float, false>(fr, veff, nbatch, r_per_b, ns, n, stream);
}

extern "C" int veff_multiply_real_c64(void* fr, const float* veff, int nbatch,
                                      int r_per_b, int ns, long long n,
                                      void* stream) {
    return launch<float, true>(fr, veff, nbatch, r_per_b, ns, n, stream);
}
