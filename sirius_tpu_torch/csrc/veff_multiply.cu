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
// Both modes come in two instantiations of one template: complex128 boxes
// with a float64 potential, and complex64 boxes with a float32 potential
// (the *_c64 entry points, the fp32 wave-function path).
//
// Bound on the H100: bytes. Each element of fr is read and written once
// (32 bytes in fp64, 16 in fp32; the real mode reads the whole element too,
// since a warp's reads of the real halves fetch every 32-byte sector), the
// potential once per batch entry; one multiply per real part.
//
// Design, for streaming at HBM3 rate in both precisions:
// - 16-byte accesses: a thread moves one float4 (two complex64 elements)
//   or one double2 (one complex128 element) with 32-bit in-row indices,
//   and reads the potential of its columns (served from L2: a row of it is
//   at most 5.8 MB at a 90^3 box).
// - One block per work item, a row (b, r) and a column tile of THREADS
//   vectors, blocks in row-major order, so the resident blocks stream
//   through fr in address order. On the H100 this ran faster, in every
//   instantiation, than one resident wave of blocks walking the items with
//   a grid stride, and than work items of 2 to 8 rows that keep the
//   potential in registers across them (PERF.md §6).
// - Alignment and tails: the vector path needs each row's vectors on
//   16-byte boundaries. A complex128 element is 16 bytes, so its rows are
//   always aligned (the wrapper refuses a base pointer that is not). A
//   complex64 row starts 8 bytes off a boundary when n is odd (every other
//   row) or the tensor is a view at an odd element offset: such a row has
//   a one-element scalar head and its vectors start one element later; a
//   row of odd length left has a one-element scalar tail. The head and
//   tail are taken by the thread of vector column 0. Every row runs on this
//   kernel: there is no scalar instantiation and no fallback.
// Each element gets exactly one multiply per part, as in the plain
// version: the result is bitwise the plain version's. Elementwise: no sums,
// no atomics.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "precision.cuh"

namespace {

constexpr int THREADS = 256;  // vectors of a work item

template <typename R>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;  // two complex64 elements
};
template <>
struct Vec16<double> {
    using type = double2;  // one complex128 element
};

// elements before the row's first 16-byte boundary: 0, or 1 for a
// complex64 row that starts 8 bytes off one
template <typename R>
__device__ __forceinline__ int head_of(const cplx_t<R>* row) {
    return (int)(((uintptr_t)row & 15) / sizeof(cplx_t<R>));
}

template <bool kReal>
__device__ __forceinline__ void scale(float4& w, const float* s) {
    w.x *= s[0];
    w.y = kReal ? 0.0f : w.y * s[0];
    w.z *= s[1];
    w.w = kReal ? 0.0f : w.w * s[1];
}

template <bool kReal>
__device__ __forceinline__ void scale(double2& w, const double* s) {
    w.x *= s[0];
    w.y = kReal ? 0.0 : w.y * s[0];
}

template <typename R, bool kReal>
__device__ __forceinline__ void scale_one(cplx_t<R>* z, R s) {
    cplx_t<R> e = *z;
    e.x *= s;
    e.y = kReal ? R(0) : e.y * s;
    *z = e;
}

template <typename R, bool kReal>
__global__ void __launch_bounds__(THREADS)
veff_multiply_kernel(cplx_t<R>* __restrict__ fr, const R* __restrict__ veff,
                     int r_per_b, int ns, int n, int coltiles) {
    using V = typename Vec16<R>::type;
    constexpr int EPV = (int)(sizeof(V) / sizeof(cplx_t<R>));
    const int row = blockIdx.x / coltiles;  // b * r_per_b + r
    const int v = (blockIdx.x - row * coltiles) * THREADS + threadIdx.x;
    const R* vs = veff + (size_t)((row / r_per_b) % ns) * n;
    cplx_t<R>* p = fr + (size_t)row * n;
    const int h = head_of<R>(p);
    const int nv = (n - h) / EPV;
    if (v < nv) {
        const int c = h + EPV * v;  // the vector's first column
        R s[EPV];
#pragma unroll
        for (int k = 0; k < EPV; ++k) s[k] = __ldg(vs + c + k);
        V w = *reinterpret_cast<const V*>(p + c);
        scale<kReal>(w, s);
        *reinterpret_cast<V*>(p + c) = w;
    }
    if (v == 0) {  // the row's scalar head and tail
        if (h) scale_one<R, kReal>(p, __ldg(vs));
        const int t = h + nv * EPV;
        if (t < n) scale_one<R, kReal>(p + t, __ldg(vs + t));
    }
}

template <typename R, bool kReal>
int launch(void* fr, const R* veff, int nbatch, int r_per_b, int ns,
           long long n, void* stream) {
    using V = typename Vec16<R>::type;
    constexpr int EPV = (int)(sizeof(V) / sizeof(cplx_t<R>));
    if (nbatch <= 0 || r_per_b <= 0 || n <= 0) return (int)cudaGetLastError();
    if (n > INT_MAX || ns <= 0) return (int)cudaErrorInvalidValue;
    // one block per (row, column tile); a row of n / EPV vectors (at least
    // one, for the scalar head and tail)
    const long long nvec = n / EPV > 0 ? n / EPV : 1;
    const long long coltiles = (nvec + THREADS - 1) / THREADS;
    const long long blocks = coltiles * nbatch * r_per_b;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    veff_multiply_kernel<R, kReal>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (cplx_t<R>*)fr, veff, r_per_b, ns, (int)n, (int)coltiles);
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
