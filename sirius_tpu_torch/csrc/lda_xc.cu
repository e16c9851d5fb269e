// K7 / K7b: pointwise LDA exchange-correlation, any sum of XC_LDA_X,
// XC_LDA_C_PZ, XC_LDA_C_PW (PW92) and XC_LDA_C_VWN (VWN5).
//
// Replaces the XLA fusion of sirius_tpu/dft/xc.py::XCFunctional._eval
// (:341-379) for the LDA functionals (:33-133): the energy per volume
// e(n_up, n_dn) and its exact derivatives v_up, v_dn, which the JAX package
// takes from jax.grad, with the same libxc-style masking: a channel below
// _DENS_TH = 1e-13 is evaluated at the threshold and its potential is zero
// (xc.py:350-371), after the _TINY = 1e-25 floor (xc.py:28,329-330).
//
// Four instantiations (kSet; kernels/lda_xc.py::COMPILED_SETS passes the
// same numbers), each polarized and unpolarized. The unpolarized form
// feeds n_up = n_dn = rho/2 and returns e and v = (v_up + v_dn)/2 in place
// of (v_up, v_dn), as xc.py:403-410 does, so no half-density arrays exist.
// - kPz, X + PZ (K7) in closed form. Unpolarized, x_pz_zeta0_points: the
//   polarized form at zeta = 0 with every term that is exactly zero or an
//   exact duplicate there left out (one pow and two cbrt a point, one PZ
//   channel). Polarized, x_pz_points: f(zeta) from the cube roots of
//   1 +- zeta that f'(zeta) takes anyway (in place of two pow), 2^(4/3) - 2
//   a literal, the polarized PZ channel sharing sqrt(rs), log(rs) and the
//   unpolarized channel's quotients. Everything that f(zeta) and f'(zeta)
//   do not multiply, exchange (its pow kept), n, zeta, rs, the unpolarized
//   PZ channel and the final sums, is written operand for operand as in
//   the zeta = 0 kernel, so the compiler contracts the same multiply-adds:
//   at n_up = n_dn, zeta = 0/n = +0, cbrt(1) - cbrt(1) = 0 and
//   1 + 1 - 2 = 0 exactly, f(zeta) = f'(zeta) = 0, and both kernels return
//   the same bits (e, v_up = v_dn = v). Off zeta = 0 only the f(zeta)
//   terms and the polarized channel round differently.
// - kPw92, kVwn: X + PW92 and X + VWN5 (K7b), lda_sets.cuh's compiled
//   sets: cube roots in place of pow, shared sqrt(rs), partials carried
//   per term, the unpolarized form specialized at zeta = 0 (eps_c the ec0
//   channel alone).
// - kMask: any other LDA sum, the energies of xc_dual.cuh on Dual<2>
//   numbers over (n_up, n_dn), which gives jax.grad's derivatives of the
//   same expressions.
//
// Bound on the H100: bytes by chip_smoke.py's counting rule. Per fine-box
// point it reads 16 bytes and writes 24 (polarized) or reads 8 and writes
// 16 (unpolarized), against ~60 fp64 flops for X + PZ and some 100-300 for
// the others by that rule; every form runs at the pace of its fp64
// instructions (pow, cbrt, log, log1p, atan and divisions are tens of
// instructions each), so the sets trade pow for cube roots and carry one
// partial a term.
//
// Design: one thread per point, grid-stride, no shared state.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "lda_sets.cuh"

namespace {

using xc::kDensTh;
using xc::kPi;
using xc::kTiny;

struct Pz {
    double eps, deps;  // eps_c(rs) and d eps_c / d rs
};

// the unpolarized PZ channel (xc.py:39-49, pol=False)
__device__ Pz pz_eps(double rs) {
    const double gamma = -0.1423, b1 = 1.0529, b2 = 0.3334;
    const double a = 0.0311, b = -0.048, c = 0.002, d = -0.0116;
    Pz out;
    if (rs >= 1.0) {
        const double srs = sqrt(rs);
        const double den = 1.0 + b1 * srs + b2 * rs;
        out.eps = gamma / den;
        out.deps = -gamma * (0.5 * b1 / srs + b2) / (den * den);
    } else {
        const double lrs = log(rs);
        out.eps = a * lrs + b + c * rs * lrs + d * rs;
        out.deps = a / rs + c * (lrs + 1.0) + d;
    }
    return out;
}

// the polarized PZ channel (xc.py:39-49, pol=True) up to rounding: its
// sqrt(rs) and log(rs), and the quotients 0.5 b1 / sqrt(rs) and a / rs,
// from the unpolarized channel's (the same expressions, evaluated once),
// one division for eps and deps
__device__ Pz pz_eps_pol(double rs) {
    Pz out;
    if (rs >= 1.0) {
        const double srs = sqrt(rs);
        const double iden = 1.0 / (1.0 + 1.3981 * srs + 0.2611 * rs);
        out.eps = -0.0843 * iden;
        out.deps = 0.0843 * (0.5 * 1.0529 / srs * (1.3981 / 1.0529) + 0.2611) * (iden * iden);
    } else {
        const double lrs = log(rs);
        out.eps = 0.01555 * lrs - 0.0269 + 0.0007 * rs * lrs - 0.0048 * rs;
        out.deps = 0.0311 / rs * 0.5 + 0.0007 * (lrs + 1.0) - 0.0048;
    }
    return out;
}

// e, v_up, v_dn at one point (inputs already thresholded)
__device__ void x_pz_polarized(double nu, double nd, double* e, double* vu,
                               double* vd) {
    nu = fmax(nu, kTiny);
    nd = fmax(nd, kTiny);
    // Slater exchange, spin-scaled
    const double cx = 0.75 * cbrt(3.0 / kPi);
    const double ex = -cx / 2.0 * (pow(2.0 * nu, 4.0 / 3.0) + pow(2.0 * nd, 4.0 / 3.0));
    const double vxu = -(4.0 / 3.0) * cx * cbrt(2.0 * nu);
    const double vxd = -(4.0 / 3.0) * cx * cbrt(2.0 * nd);
    // Perdew-Zunger 81 correlation with the zeta interpolation
    const double n = nu + nd;
    const double zeta = fmin(fmax((nu - nd) / n, -1.0), 1.0);
    const double rs = cbrt(3.0 / (4.0 * kPi * n));
    const Pz u = pz_eps(rs);
    const Pz p = pz_eps_pol(rs);
    // f(zeta) and f'(zeta) from (1 +- zeta)^(1/3) (xc_sets.cuh's zeta_f_c)
    const double cp = cbrt(1.0 + zeta);
    const double cm = cbrt(1.0 - zeta);
    const double fz = ((1.0 + zeta) * cp + (1.0 - zeta) * cm - 2.0) * (1.0 / xc::kFzDen);
    const double dfz = (4.0 / 3.0) * (cp - cm) * (1.0 / xc::kFzDen);
    const double eps = u.eps + fz * (p.eps - u.eps);
    const double deps_drs = u.deps + fz * (p.deps - u.deps);
    const double deps_dz = dfz * (p.eps - u.eps);
    const double common = eps - rs / 3.0 * deps_drs;
    *e = ex + n * eps;
    *vu = vxu + common + (1.0 - zeta) * deps_dz;
    *vd = vxd + common - (1.0 + zeta) * deps_dz;
}

// x_pz_polarized at nu = nd = nh (thresholded): e and v = v_up = v_dn
__device__ void x_pz_zeta0(double nh, double* e, double* v) {
    nh = fmax(nh, kTiny);
    const double cx = 0.75 * cbrt(3.0 / kPi);
    const double px = pow(2.0 * nh, 4.0 / 3.0);
    const double ex = -cx / 2.0 * (px + px);
    const double vx = -(4.0 / 3.0) * cx * cbrt(2.0 * nh);
    const double n = nh + nh;
    const double rs = cbrt(3.0 / (4.0 * kPi * n));
    const Pz u = pz_eps(rs);
    const double common = u.eps - rs / 3.0 * u.deps;
    *e = ex + n * u.eps;
    *v = vx + common;
}

// any LDA sum on duals (inputs already thresholded)
__device__ void lda_dual(int mask, double nu, double nd, double* e, double* vu,
                         double* vd) {
    using D = xc::Dual<2>;
    const D z = xc::constant<2>(0.0);
    const D out = xc::energy<2>(mask, xc::seed<2>(nu, 0), xc::seed<2>(nd, 1), z, z, z);
    *e = out.v;
    *vu = out.d[0];
    *vd = out.d[1];
}

__global__ void lda_xc_points(const double* __restrict__ nu_in,
                              const double* __restrict__ nd_in,
                              double* __restrict__ e_out,
                              double* __restrict__ vu_out,
                              double* __restrict__ vd_out, long long n,
                              int unpolarized, int mask) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        double nu, nd;
        if (unpolarized) {
            nu = 0.5 * nu_in[i];
            nd = nu;
        } else {
            nu = nu_in[i];
            nd = nd_in[i];
        }
        const bool up0 = nu < kDensTh;
        const bool dn0 = nd < kDensTh;
        double e, vu, vd;
        lda_dual(mask, up0 ? kDensTh : nu, dn0 ? kDensTh : nd, &e, &vu, &vd);
        if (up0) vu = 0.0;
        if (dn0) vd = 0.0;
        e_out[i] = e;
        if (unpolarized) {
            vu_out[i] = 0.5 * (vu + vd);
        } else {
            vu_out[i] = vu;
            vd_out[i] = vd;
        }
    }
}

// polarized X + PZ: nu, nd -> e, v_up, v_dn
__global__ void x_pz_points(const double* __restrict__ nu_in,
                            const double* __restrict__ nd_in,
                            double* __restrict__ e_out,
                            double* __restrict__ vu_out,
                            double* __restrict__ vd_out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const double nu = nu_in[i];
        const double nd = nd_in[i];
        const bool up0 = nu < kDensTh;
        const bool dn0 = nd < kDensTh;
        double e, vu, vd;
        x_pz_polarized(up0 ? kDensTh : nu, dn0 ? kDensTh : nd, &e, &vu, &vd);
        e_out[i] = e;
        vu_out[i] = up0 ? 0.0 : vu;
        vd_out[i] = dn0 ? 0.0 : vd;
    }
}

// unpolarized X + PZ: rho -> e, v
__global__ void x_pz_zeta0_points(const double* __restrict__ rho,
                                  double* __restrict__ e_out,
                                  double* __restrict__ v_out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const double nh = 0.5 * rho[i];
        const bool dead = nh < kDensTh;
        double e, v;
        x_pz_zeta0(dead ? kDensTh : nh, &e, &v);
        e_out[i] = e;
        v_out[i] = dead ? 0.0 : v;
    }
}

// a compiled set (lda_sets.cuh), polarized: nu, nd -> e, v_up, v_dn
template <class Set>
__global__ void lda_set_polarized(const double* __restrict__ nu_in,
                                  const double* __restrict__ nd_in,
                                  double* __restrict__ e_out,
                                  double* __restrict__ vu_out,
                                  double* __restrict__ vd_out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const double nu = nu_in[i];
        const double nd = nd_in[i];
        const bool up0 = nu < kDensTh;
        const bool dn0 = nd < kDensTh;
        double e, vu, vd;
        xc::lda_set_point<Set>(up0 ? kDensTh : nu, dn0 ? kDensTh : nd, &e, &vu, &vd);
        e_out[i] = e;
        vu_out[i] = up0 ? 0.0 : vu;
        vd_out[i] = dn0 ? 0.0 : vd;
    }
}

// a compiled set, unpolarized: rho -> e, v
template <class Set>
__global__ void lda_set_unpolarized(const double* __restrict__ rho,
                                    double* __restrict__ e_out,
                                    double* __restrict__ v_out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const double nh = 0.5 * rho[i];
        const bool dead = nh < kDensTh;
        double e, v;
        xc::lda_set_point_zeta0<Set>(dead ? kDensTh : nh, &e, &v);
        e_out[i] = e;
        v_out[i] = dead ? 0.0 : v;
    }
}

// instantiations; kernels/lda_xc.py::COMPILED_SETS passes the same numbers
enum : int { kMask = 0, kPz = 1, kPw92 = 2, kVwn = 3 };

// the functional mask of a compiled set
constexpr int set_mask(int set) {
    return set == kPz     ? (xc::kLdaX | xc::kLdaCPz)
           : set == kPw92 ? (xc::kLdaX | xc::kLdaCPw)
           : set == kVwn  ? (xc::kLdaX | xc::kLdaCVwn)
                          : 0;
}

template <class Set>
void launch_set(const double* nu, const double* nd, double* e, double* vu,
                double* vd, long long n, int unpolarized, int blocks,
                int threads, cudaStream_t s) {
    if (unpolarized)
        lda_set_unpolarized<Set><<<blocks, threads, 0, s>>>(nu, e, vu, n);
    else
        lda_set_polarized<Set><<<blocks, threads, 0, s>>>(nu, nd, e, vu, vd, n);
}

}  // namespace

// Polarized: nu, nd -> e, vu, vd. Unpolarized (unpolarized != 0): nu holds
// rho, nd and vd are unused, vu receives v = (v_up + v_dn) / 2. mask: the
// functionals summed (LDA bits of xc_dual.cuh only); set picks the
// instantiation (kMask, kPz, kPw92, kVwn), and a compiled set's mask must be
// that set's. Any other mask or set returns cudaErrorInvalidValue without a
// launch.
extern "C" int lda_xc(const double* nu, const double* nd, double* e, double* vu,
                      double* vd, long long n, int unpolarized, int mask, int set,
                      void* stream) {
    if (mask == 0 || (mask & ~xc::kLdaBits)) return (int)cudaErrorInvalidValue;
    if (set < kMask || set > kVwn || (set != kMask && mask != set_mask(set)))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks <= 0) return (int)cudaGetLastError();
    const int b = (int)blocks;
    cudaStream_t s = (cudaStream_t)stream;
    if (set == kPz && unpolarized)
        x_pz_zeta0_points<<<b, threads, 0, s>>>(nu, e, vu, n);
    else if (set == kPz)
        x_pz_points<<<b, threads, 0, s>>>(nu, nd, e, vu, vd, n);
    else if (set == kPw92)
        launch_set<xc::Pw92Set>(nu, nd, e, vu, vd, n, unpolarized, b, threads, s);
    else if (set == kVwn)
        launch_set<xc::VwnSet>(nu, nd, e, vu, vd, n, unpolarized, b, threads, s);
    else
        lda_xc_points<<<b, threads, 0, s>>>(nu, nd, e, vu, vd, n, unpolarized, mask);
    return (int)cudaGetLastError();
}
