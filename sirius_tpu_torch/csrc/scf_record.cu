// K15: the fused SCF step's scalar record, as one batched reduction.
//
// Replaces the scalar reductions of sirius_tpu/dft/fused.py::_step_impl
// (:400-459; the energy integrals of dft/potential.py's device form, the
// Harris terms e1 / e2 :358-375, the numerics ledger and the finiteness
// sentinel), which XLA fuses into the jitted step before its one
// [NUM_SCALARS] readback. A table of segments, each one reduction over one
// vector, writes the record: a slot is the sum, the max or the "all
// finite" of its segments, combined in table order. The ops:
//   0 sum      sum_i a_i                       (float64; n = 1 copies)
//   1 dot      sum_i a_i b_i                   (float64)
//   2 dot_c    sum_i Re conj(a_i) b_i          (complex128)
//   3 maxabs_c max_i |a_i - b_i| (|a_i| without b; complex128)
//   4 maxabs   max_i |a_i - b_i|               (float64)
//   5 eye      max_i |a_i - I|, a [.., p, p]   (complex128)
//   6 herm     max_i |a_i - conj(a^T)_i|, a [.., p, p] (complex128)
//   7 finite   1 if every a_i is finite, else 0 (float64)
// each times the segment's scale. Sums and maxima propagate a NaN, as the
// JAX package's jnp.sum and jnp.max do.
//
// Bound on the H100: bytes (each segment's vectors read once; the largest
// are the potential's fine boxes), and at the small decks the launch
// latency of the two passes.
//
// Design: the table travels by value in the launch parameters (no upload,
// so nothing waits on the host); the grid is (blocks a segment, segments),
// every block walks its share of its segment in a fixed grid-stride order
// and reduces in a fixed tree; one block then adds each segment's partials
// in block order and combines the segments of a slot in table order:
// deterministic, no atomics.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSeg = 40;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 128;

enum Op { kSum = 0, kDot, kDotC, kMaxAbsC, kMaxAbs, kEye, kHerm, kFinite };

struct Seg {
    long long a, b, n;
    int op, slot, param;
    double scale;
};

struct Table {
    Seg seg[kMaxSeg];
};

__device__ __forceinline__ double nan_max(double a, double b) {
    return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ int kind_of(int op) {
    return op <= kDotC ? 0 : (op == kFinite ? 2 : 1);  // sum, max, finite
}

__device__ __forceinline__ double combine(int kind, double a, double b) {
    if (kind == 0) return a + b;
    if (kind == 1) return nan_max(a, b);
    return a < b ? a : b;
}

__device__ double element(const Seg& s, long long i) {
    const double* a = (const double*)s.a;
    const double* b = (const double*)s.b;
    switch (s.op) {
        case kSum:
            return a[i];
        case kDot:
            return a[i] * b[i];
        case kDotC:
            return a[2 * i] * b[2 * i] + a[2 * i + 1] * b[2 * i + 1];
        case kMaxAbsC: {
            double x = a[2 * i], y = a[2 * i + 1];
            if (b) {
                x -= b[2 * i];
                y -= b[2 * i + 1];
            }
            return hypot(x, y);
        }
        case kMaxAbs:
            return fabs(b ? a[i] - b[i] : a[i]);
        case kEye: {
            const long long p = s.param, e = i % (p * p);
            const double re = a[2 * i] - (e / p == e % p ? 1.0 : 0.0);
            return hypot(re, a[2 * i + 1]);
        }
        case kHerm: {
            const long long p = s.param, e = i % (p * p), base = i - e;
            const long long r = e / p, c = e % p, tr = base + c * p + r;
            return hypot(a[2 * i] - a[2 * tr], a[2 * i + 1] + a[2 * tr + 1]);
        }
        default:
            return isfinite(a[i]) ? 1.0 : 0.0;
    }
}

__global__ void __launch_bounds__(kThreads)
record_partials(Table tb, int nblk, double* __restrict__ partials) {
    __shared__ double red[kThreads];
    const Seg& s = tb.seg[blockIdx.y];
    const int kind = kind_of(s.op);
    double v = kind == 2 ? 1.0 : 0.0;
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
         i < s.n; i += (long long)nblk * kThreads)
        v = combine(kind, v, element(s, i));
    red[threadIdx.x] = v;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k)
            red[threadIdx.x] = combine(kind, red[threadIdx.x],
                                       red[threadIdx.x + k]);
        __syncthreads();
    }
    if (threadIdx.x == 0)
        partials[(long long)blockIdx.y * nblk + blockIdx.x] = red[0];
}

__global__ void record_reduce(Table tb, int nseg, int nblk, int nslots,
                              const double* __restrict__ partials,
                              double* __restrict__ record) {
    const int slot = threadIdx.x;
    if (slot >= nslots) return;
    double val = 0.0;
    bool first = true;
    for (int k = 0; k < nseg; ++k) {
        const Seg& s = tb.seg[k];
        if (s.slot != slot) continue;
        const int kind = kind_of(s.op);
        double v = partials[(long long)k * nblk];
        for (int b = 1; b < nblk; ++b)
            v = combine(kind, v, partials[(long long)k * nblk + b]);
        v = v * s.scale;
        val = first ? v : combine(kind, val, v);
        first = false;
    }
    record[slot] = val;
}

}  // namespace

// ptrs [nseg, 3] (a, b, n), ints [nseg, 3] (op, slot, param), scales
// [nseg]: host arrays. partials: kMaxBlocks * nseg doubles of scratch.
extern "C" int scf_record(const long long* ptrs, const int* ints,
                          const double* scales, int nseg, int nslots,
                          double* partials, double* record, void* stream) {
    if (nseg < 1 || nseg > kMaxSeg || nslots < 1 || nslots > kThreads)
        return (int)cudaErrorInvalidValue;
    Table tb;
    long long nmax = 1;
    for (int k = 0; k < nseg; ++k) {
        tb.seg[k].a = ptrs[3 * k];
        tb.seg[k].b = ptrs[3 * k + 1];
        tb.seg[k].n = ptrs[3 * k + 2];
        tb.seg[k].op = ints[3 * k];
        tb.seg[k].slot = ints[3 * k + 1];
        tb.seg[k].param = ints[3 * k + 2];
        tb.seg[k].scale = scales[k];
        if (tb.seg[k].n > nmax) nmax = tb.seg[k].n;
        if (tb.seg[k].op < kSum || tb.seg[k].op > kFinite ||
            tb.seg[k].slot < 0 || tb.seg[k].slot >= nslots)
            return (int)cudaErrorInvalidValue;
    }
    long long nblk = (nmax + kThreads * 4 - 1) / (kThreads * 4);
    if (nblk > kMaxBlocks) nblk = kMaxBlocks;
    cudaStream_t s = (cudaStream_t)stream;
    record_partials<<<dim3((unsigned)nblk, (unsigned)nseg), kThreads, 0, s>>>(
        tb, (int)nblk, partials);
    record_reduce<<<1, kThreads, 0, s>>>(tb, nseg, (int)nblk, nslots,
                                         partials, record);
    return (int)cudaGetLastError();
}
