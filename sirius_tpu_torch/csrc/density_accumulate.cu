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
// Both come in two instantiations of one template: complex128 boxes (the
// plain names) and complex64 boxes (the *_c64 names, the fp32
// wave-function path). The fp32 one reads half the bytes; each element is
// widened to double before it is squared, and occ_w, the sums and acc stay
// float64, as the JAX package promotes |fr|^2 into its float64 occupation
// sum (batched.py:343).
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

template <typename R>
__global__ void accumulate(const cplx_t<R>* __restrict__ fr,
                           const double* __restrict__ occ_w,
                           double* __restrict__ acc, int ns, int nb,
                           long long n, double scale) {
    const long long total = (long long)ns * n;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const long long s = t / n;
        const long long r = t - s * n;
        const cplx_t<R>* f = fr + s * (long long)nb * n + r;
        const double* o = occ_w + s * nb;
        double sum = 0.0;
        for (int b = 0; b < nb; ++b) {
            const cplx_t<R> v = f[(long long)b * n];
            const double vx = v.x, vy = v.y;
            sum += o[b] * (vx * vx + vy * vy);
        }
        acc[t] += scale * sum;
    }
}

template <typename R>
__global__ void accumulate_nc(const cplx_t<R>* __restrict__ fr,
                              const double* __restrict__ occ_w,
                              double* __restrict__ acc, int nb, long long n,
                              double scale) {
    for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         r < n; r += (long long)gridDim.x * blockDim.x) {
        double up = 0.0, dn = 0.0, zr = 0.0, zi = 0.0;
        for (int b = 0; b < nb; ++b) {
            const cplx_t<R> uf = fr[(2LL * b) * n + r];
            const cplx_t<R> df = fr[(2LL * b + 1) * n + r];
            const double ux = uf.x, uy = uf.y, dx = df.x, dy = df.y;
            const double w = occ_w[b];
            up += w * (ux * ux + uy * uy);
            dn += w * (dx * dx + dy * dy);
            // u conj(d)
            zr += w * (ux * dx + uy * dy);
            zi += w * (uy * dx - ux * dy);
        }
        acc[r] += scale * (up + dn);
        acc[n + r] += scale * (up - dn);
        acc[2 * n + r] += scale * (2.0 * zr);
        acc[3 * n + r] += scale * (-2.0 * zi);
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    return (int)blocks;
}

template <typename R>
int launch_nc(const void* fr, const double* occ_w, double* acc, int nb,
              long long n, double scale, void* stream) {
    const int threads = 256;
    const int blocks = grid_for(n, threads);
    if (blocks > 0)
        accumulate_nc<R><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const cplx_t<R>*)fr, occ_w, acc, nb, n, scale);
    return (int)cudaGetLastError();
}

template <typename R>
int launch(const void* fr, const double* occ_w, double* acc, int ns, int nb,
           long long n, double scale, void* stream) {
    const int threads = 256;
    const int blocks = grid_for((long long)ns * n, threads);
    if (blocks > 0)
        accumulate<R><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const cplx_t<R>*)fr, occ_w, acc, ns, nb, n, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int density_accumulate_nc(const void* fr, const double* occ_w,
                                     double* acc, int nb, long long n,
                                     double scale, void* stream) {
    return launch_nc<double>(fr, occ_w, acc, nb, n, scale, stream);
}

extern "C" int density_accumulate_nc_c64(const void* fr, const double* occ_w,
                                         double* acc, int nb, long long n,
                                         double scale, void* stream) {
    return launch_nc<float>(fr, occ_w, acc, nb, n, scale, stream);
}

extern "C" int density_accumulate(const void* fr, const double* occ_w,
                                  double* acc, int ns, int nb, long long n,
                                  double scale, void* stream) {
    return launch<double>(fr, occ_w, acc, ns, nb, n, scale, stream);
}

extern "C" int density_accumulate_c64(const void* fr, const double* occ_w,
                                      double* acc, int ns, int nb,
                                      long long n, double scale,
                                      void* stream) {
    return launch<float>(fr, occ_w, acc, ns, nb, n, scale, stream);
}
