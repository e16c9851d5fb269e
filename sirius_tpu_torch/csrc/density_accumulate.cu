// K3: occupation-weighted |psi(r)|^2 accumulation on the coarse box.
//
// Replaces the XLA fusion of sirius_tpu/parallel/batched.py::density_kset
// (:328-345; same body as dft/density.py::_accumulate_k :34-46) after the
// batched inverse FFT: acc[s, r] += scale * sum_b occ_w[s, b] |fr[s, b, r]|^2
// with scale = N^2 for the "* n" of batched.py:342.
//
// Bound on the H100: bytes. It reads the [ns, nb, N] complex box once
// (16 bytes per element for 3 flops) and reads and writes acc once.
//
// Design: one thread per (spin, grid point) walks the bands in order, so the
// [nb, N] |psi|^2 intermediate never exists, neighbouring threads read
// neighbouring box points (coalesced), and the sum is deterministic with no
// atomics. The k-points are summed by launches in k order on one stream.
//
// K12b (density_accumulate_nc) is its four-component spinor form, replacing
// the fusion of sirius_tpu/parallel/batched_nc.py::density_kset_nc
// (:141-152): from the box [nb, 2, N] of one k-point's spinor bands
// (component 0 up, 1 down) and occ_w [nb],
//   acc[0, r] += scale sum_b w_b (|u|^2 + |d|^2)        (rho)
//   acc[1, r] += scale sum_b w_b (|u|^2 - |d|^2)        (m_z)
//   acc[2, r] += 2 scale sum_b w_b Re(u conj d)         (m_x)
//   acc[3, r] += -2 scale sum_b w_b Im(u conj d)        (m_y)
// the reference's (rho, m_z, m_x, m_y) order. Bound by bytes as K3: it reads
// the box once (32 bytes a point and band for 12 flops) and reads and
// writes acc once. One thread per grid point walks the bands in order,
// carrying the four sums in registers: deterministic, no atomics.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

__global__ void accumulate(const cuDoubleComplex* __restrict__ fr,
                           const double* __restrict__ occ_w,
                           double* __restrict__ acc, int ns, int nb,
                           long long n, double scale) {
    const long long total = (long long)ns * n;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const long long s = t / n;
        const long long r = t - s * n;
        const cuDoubleComplex* f = fr + s * (long long)nb * n + r;
        const double* o = occ_w + s * nb;
        double sum = 0.0;
        for (int b = 0; b < nb; ++b) {
            const cuDoubleComplex v = f[(long long)b * n];
            sum += o[b] * (v.x * v.x + v.y * v.y);
        }
        acc[t] += scale * sum;
    }
}

__global__ void accumulate_nc(const cuDoubleComplex* __restrict__ fr,
                              const double* __restrict__ occ_w,
                              double* __restrict__ acc, int nb, long long n,
                              double scale) {
    for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         r < n; r += (long long)gridDim.x * blockDim.x) {
        double up = 0.0, dn = 0.0, zr = 0.0, zi = 0.0;
        for (int b = 0; b < nb; ++b) {
            const cuDoubleComplex u = fr[(2LL * b) * n + r];
            const cuDoubleComplex d = fr[(2LL * b + 1) * n + r];
            const double w = occ_w[b];
            up += w * (u.x * u.x + u.y * u.y);
            dn += w * (d.x * d.x + d.y * d.y);
            // u conj(d)
            zr += w * (u.x * d.x + u.y * d.y);
            zi += w * (u.y * d.x - u.x * d.y);
        }
        acc[r] += scale * (up + dn);
        acc[n + r] += scale * (up - dn);
        acc[2 * n + r] += scale * (2.0 * zr);
        acc[3 * n + r] += scale * (-2.0 * zi);
    }
}

}  // namespace

extern "C" int density_accumulate_nc(const void* fr, const double* occ_w,
                                     double* acc, int nb, long long n,
                                     double scale, void* stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks > 0)
        accumulate_nc<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)fr, occ_w, acc, nb, n, scale);
    return (int)cudaGetLastError();
}

extern "C" int density_accumulate(const void* fr, const double* occ_w,
                                  double* acc, int ns, int nb, long long n,
                                  double scale, void* stream) {
    const int threads = 256;
    long long blocks = ((long long)ns * n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks > 0)
        accumulate<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)fr, occ_w, acc, ns, nb, n, scale);
    return (int)cudaGetLastError();
}
