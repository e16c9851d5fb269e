// K13: the Fermi level by bisection, the occupations and the entropy sum.
//
// Replaces sirius_tpu/dft/occupation.py::find_fermi (:68-103), one jitted
// fori_loop there: 80 bisection steps of
//   count(mu) = max_occ * sum_i w_k(i) f((mu - e_i) / width)
// against the electron count, lo / hi starting at min(e) - 10 and
// max(e) + 10, then occ_i = max_occ f((mu - e_i) / width) and
// ent = max_occ * sum_i w_k(i) s(mu - e_i), for the four smearing kinds of
// the reference (smearing.cpp): Gaussian, Fermi-Dirac, cold and first-order
// Methfessel-Paxton. The port's plain version (kernels/fermi.py) is the
// PyTorch form of the same expressions, about ten launches a step.
//
// Bound on the H100: latency. The evals are a few thousand values (16 atoms
// NC: 8 x 1 x 42; 54 atoms: 1 x 1 x 129); the 80 dependent steps each end
// in a block reduction and a broadcast, so the launch latency (a few us)
// and 80 x (one pass over n values + a log2(256) tree) bound it.
//
// Design: one block of 256 threads. The evals go into shared memory when
// they fit (kSmem values; else they are read from device memory, so any
// size works). Each step every thread sums its values i = t, t + 256, ...
// in order, the block adds the 256 partial sums in a fixed tree, and every
// thread reads the same count and updates the same (lo, hi): deterministic,
// no atomics. The clamps are the plain version's, written as comparisons so
// that a NaN passes through as it does in torch.clamp; products that the
// plain version rounds apart are kept apart (__dmul_rn, __dadd_rn).
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmem = 4096;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrtPi = 1.7724538509055159;
constexpr double kSqrt2Pi = 2.5066282746310002;  // math.sqrt(2 pi)

enum Kind { kGaussian = 0, kFermiDirac = 1, kCold = 2, kMethfesselPaxton = 3 };

__device__ __forceinline__ double clamp_hi(double v, double hi) {
    return v > hi ? hi : v;
}
__device__ __forceinline__ double clamp2(double v, double lo, double hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// f(x) in [0, 1] with x = mu - eps (kernels/fermi.py::occupancy)
__device__ double occupancy(int kind, double x, double w) {
    const double t = x / w;
    if (kind == kGaussian) return 0.5 * (1.0 + erf(t));
    if (kind == kFermiDirac)
        return 1.0 - 1.0 / (1.0 + exp(clamp2(t, -200.0, 200.0)));
    if (kind == kCold) {
        const double y = t - 1.0 / kSqrt2;
        return __dadd_rn(0.5 * (1.0 + erf(y)),
                         exp(-clamp_hi(__dmul_rn(y, y), 200.0)) / kSqrt2Pi);
    }
    const double e = exp(-clamp_hi(__dmul_rn(t, t), 200.0));
    return __dadd_rn(0.5 * (1.0 + erf(t)),
                     __dmul_rn(2.0 * t, e) / (4.0 * kSqrtPi));
}

// the per-state entropy term (kernels/fermi.py::entropy_term)
__device__ double entropy_term(int kind, double x, double w) {
    const double t = x / w;
    if (kind == kGaussian)
        return __dmul_rn(-exp(-clamp_hi(__dmul_rn(t, t), 200.0)), w) /
               (2.0 * kSqrtPi);
    if (kind == kFermiDirac) {
        const double f = 1.0 / (1.0 + exp(clamp2(t, -200.0, 200.0)));
        const double fl = clamp2(f, 1e-30, 1.0);
        const double gl = clamp2(1.0 - f, 1e-30, 1.0);
        return __dmul_rn(w, __dadd_rn(__dmul_rn(f, log(fl)),
                                      __dmul_rn(1.0 - f, log(gl))));
    }
    if (kind == kCold) {
        const double y = t - 1.0 / kSqrt2;
        return __dmul_rn(-exp(-clamp_hi(__dmul_rn(y, y), 200.0)),
                         __dsub_rn(w, __dmul_rn(kSqrt2, x))) /
               (2.0 * kSqrtPi);
    }
    const double e = exp(-clamp_hi(__dmul_rn(t, t), 200.0));
    return __dmul_rn(__dmul_rn(w, __dsub_rn(__dmul_rn(2.0 * t, t), 1.0)), e) /
           (4.0 * kSqrtPi);
}

// NaN-propagating min / max (torch.min / torch.max of the plain version)
__device__ __forceinline__ double nan_min(double a, double b) {
    return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ double nan_max(double a, double b) {
    return (a != a || a > b) ? a : b;
}

// sum (or min / max) of one value a thread over the block, in a fixed
// tree; every thread returns the total
template <int Op>
__device__ double block_reduce(double v, double* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) {
            const double a = red[threadIdx.x], b = red[threadIdx.x + s];
            red[threadIdx.x] = Op == 0 ? __dadd_rn(a, b)
                               : Op == 1 ? nan_min(a, b)
                                         : nan_max(a, b);
        }
        __syncthreads();
    }
    const double total = red[0];
    __syncthreads();
    return total;
}

__global__ void __launch_bounds__(kThreads)
fermi_kernel(const double* __restrict__ ev_g, const double* __restrict__ kw,
             int n, int per_k, double nel, double width, double max_occ,
             int kind, int num_iter, double* __restrict__ occ,
             double* __restrict__ out) {
    __shared__ double s_ev[kSmem];
    __shared__ double red[kThreads];
    const double* ev = ev_g;
    if (n <= kSmem) {
        for (int i = threadIdx.x; i < n; i += kThreads) s_ev[i] = ev_g[i];
        __syncthreads();
        ev = s_ev;
    }
    double lo = ev[0], hi = ev[0];
    for (int i = threadIdx.x; i < n; i += kThreads) {
        lo = nan_min(lo, ev[i]);
        hi = nan_max(hi, ev[i]);
    }
    lo = block_reduce<1>(lo, red) - 10.0;
    hi = block_reduce<2>(hi, red) + 10.0;
    for (int it = 0; it < num_iter; ++it) {
        const double mid = 0.5 * (lo + hi);
        double s = 0.0;
        for (int i = threadIdx.x; i < n; i += kThreads)
            s = __dadd_rn(s, __dmul_rn(kw[i / per_k],
                                       occupancy(kind, mid - ev[i], width)));
        const double count = __dmul_rn(block_reduce<0>(s, red), max_occ);
        const bool too_low = count < nel;
        lo = too_low ? mid : lo;
        hi = too_low ? hi : mid;
    }
    const double mu = 0.5 * (lo + hi);
    double s = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const double x = mu - ev[i];
        occ[i] = __dmul_rn(max_occ, occupancy(kind, x, width));
        s = __dadd_rn(s, __dmul_rn(kw[i / per_k], entropy_term(kind, x, width)));
    }
    const double ent = __dmul_rn(max_occ, block_reduce<0>(s, red));
    if (threadIdx.x == 0) {
        out[0] = mu;
        out[1] = ent;
    }
}

}  // namespace

extern "C" int fermi_level(const double* ev, const double* kw, int n,
                           int per_k, double nel, double width,
                           double max_occ, int kind, int num_iter,
                           double* occ, double* out, void* stream) {
    if (n > 0)
        fermi_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
            ev, kw, n, per_k, nel, width, max_occ, kind, num_iter, occ, out);
    return (int)cudaGetLastError();
}
