// K12a: the 2x2 spinor potential applied in real space, in place.
//
// Replaces the XLA fusion between the two FFTs of
// sirius_tpu/ops/spinor.py::apply_h_s_nc (:58-66):
//   u' = u v_uu + d (B_x - i B_y)
//   d' = d v_dd + u (B_x + i B_y)
// with fr the complex128 inverse-FFT box [rows, 2, n] of a block of spinor
// bands (spin component 0 = up, 1 = down) and v_uu = V + B_z, v_dd = V - B_z,
// B_x, B_y the float64 coarse-box fields [n].
//
// Bound on the H100: bytes. Each point of a row reads and writes both spin
// components (64 bytes) for 16 multiplies and adds; the four fields (32 bytes
// a point, <= 6.9 MB at a 60^3 box) are re-read per row but stay in the
// 50 MB L2.
//
// Design: one thread owns one point of one row and reads both spin
// components, so the update needs no temporary box. blockIdx.y walks the
// rows, the x dimension the n points, so neighbouring threads read
// neighbouring 16-byte elements (coalesced) and no thread divides a 64-bit
// index. Elementwise: no sums, no atomics, bit-reproducible.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

__global__ void spinor_veff_kernel(cuDoubleComplex* __restrict__ fr,
                                   const double* __restrict__ v_uu,
                                   const double* __restrict__ v_dd,
                                   const double* __restrict__ bx,
                                   const double* __restrict__ by,
                                   long long rows, long long n) {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        cuDoubleComplex* up = fr + row * 2 * n;
        cuDoubleComplex* dn = up + n;
        for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
             i < n; i += (long long)gridDim.x * blockDim.x) {
            const cuDoubleComplex u = up[i];
            const cuDoubleComplex d = dn[i];
            const double a = v_uu[i], b = v_dd[i], x = bx[i], y = by[i];
            // d (x - i y) and u (x + i y)
            const double dm_re = d.x * x + d.y * y;
            const double dm_im = d.y * x - d.x * y;
            const double up_re = u.x * x - u.y * y;
            const double up_im = u.y * x + u.x * y;
            up[i] = make_cuDoubleComplex(u.x * a + dm_re, u.y * a + dm_im);
            dn[i] = make_cuDoubleComplex(d.x * b + up_re, d.y * b + up_im);
        }
    }
}

}  // namespace

extern "C" int spinor_veff(void* fr, const double* v_uu, const double* v_dd,
                           const double* bx, const double* by, long long rows,
                           long long n, void* stream) {
    const int threads = 256;
    if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
    long long bx_blocks = (n + threads - 1) / threads;
    // enough blocks per row to fill the card at small row counts, a grid
    // stride beyond that
    if (bx_blocks > 1024) bx_blocks = 1024;
    const long long by_blocks = rows < 65535 ? rows : 65535;
    dim3 grid((unsigned)bx_blocks, (unsigned)by_blocks);
    spinor_veff_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (cuDoubleComplex*)fr, v_uu, v_dd, bx, by, rows, n);
    return (int)cudaGetLastError();
}
