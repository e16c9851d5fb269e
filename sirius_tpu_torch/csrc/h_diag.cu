// K18: the elementwise pass of the H preconditioner diagonal,
// parallel/batched.py::compute_h_diag.
//
// Replaces the XLA fusion of sirius_tpu/parallel/batched.py::
// compute_h_diag_device (:102-116) after its projector product: the add
// of the kinetic energy and v0 = Re veff(G = 0), the add of the real part
// of sum_xy conj(beta_x) D_xy beta_y (the "kxg,sxy,kyg->ksg" product,
// which stays a cuBLAS product as the JAX package leaves it to XLA's dot),
// and the masked select:
//   h[k, s, g] = mask[k, g] > 0 ? (ekin[k, g] + v0) + Re q[k, s, g] : 1e4
// q may be absent (no projectors): then h = ekin + v0 on every spin. v0 is
// read from device memory (a 0-d tensor, no host read).
//
// Bits: the plain version's, (ekin + v0) + Re q in that order, both adds
// rounded alone (no FMA can form: there is no product).
//
// Bound on the H100: bytes. It reads ekin and mask once ([nk, ngk] float64
// each) and q ([nk, ns, ngk] complex128, of which the real halves: the
// loads are 8 bytes with a 16-byte stride), and writes [nk, ns, ngk]
// float64. One thread an element, consecutive threads on consecutive g.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void h_diag_kernel(const double* __restrict__ ekin,
                              const double* __restrict__ mask,
                              const double* __restrict__ q,
                              const double* __restrict__ v0, int nk, int ns,
                              long long ngk, double* __restrict__ out) {
    const long long n = (long long)nk * ns * ngk;
    const double v = *v0;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const long long ks = i / ngk;
        const long long g = i - ks * ngk;
        const long long kg = (ks / ns) * ngk + g;
        double h = ekin[kg] + v;
        if (q) h = h + q[2 * i];
        out[i] = mask[kg] > 0.0 ? h : 1e4;
    }
}

int blocks_for(long long n) {
    long long b = (n + kThreads - 1) / kThreads;
    if (b > 65535LL * 32) b = 65535LL * 32;
    return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

// ekin, mask [nk, ngk] float64; q [nk, ns, ngk] complex128 or null; v0 a
// float64 scalar on the device; out [nk, ns, ngk] float64
extern "C" int h_diag(const void* ekin, const void* mask, const void* q,
                      const void* v0, int nk, int ns, long long ngk,
                      void* out, void* stream) {
    h_diag_kernel<<<blocks_for((long long)nk * ns * ngk), kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const double*)ekin, (const double*)mask, (const double*)q,
        (const double*)v0, nk, ns, ngk, (double*)out);
    return (int)cudaGetLastError();
}
