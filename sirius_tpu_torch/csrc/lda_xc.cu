// K7 / K7b: pointwise LDA exchange-correlation, any sum of XC_LDA_X,
// XC_LDA_C_PZ, XC_LDA_C_PW (PW92) and XC_LDA_C_VWN (VWN5).
//
// Replaces the XLA fusion of sirius_tpu/dft/xc.py::XCFunctional._eval
// (:341-379) for the LDA functionals (:33-133): the energy per volume
// e(n_up, n_dn) and its exact derivatives v_up, v_dn, which the JAX package
// takes from jax.grad, with the same libxc-style masking: a channel below
// _DENS_TH = 1e-13 is evaluated at the threshold and its potential is zero
// (xc.py:350-371), after the _TINY = 1e-25 floor (xc.py:28,329-330).
// The functional mask (bits of xc_dual.cuh) selects the sum, so one launch
// evaluates a deck's whole LDA list. X + PZ alone (K7) keeps its
// closed-form derivatives; every other sum (K7b) evaluates the energies of
// xc_dual.cuh on Dual<2> numbers over (n_up, n_dn), which gives jax.grad's
// derivatives of the same expressions.
//
// Bound on the H100: bytes for X + PZ. Per fine-box point it reads 16 bytes
// and writes 24 (polarized) or reads 8 and writes 16 (unpolarized), against
// ~60 fp64 flops including cbrt/pow/log/sqrt. PW92 and VWN5 on duals take
// some 300 fp64 operations a point (pow, log1p, atan on the value and three
// numbers a step), near the line where the fp64 rate binds.
//
// Design: one thread per point, no shared state. The unpolarized form feeds
// n_up = n_dn = rho/2 and returns e and v = (v_up + v_dn)/2 in place of
// (v_up, v_dn), as xc.py:403-410 does, so no half-density arrays exist.
// Unpolarized X + PZ (K7 on most decks) launches its own kernel,
// x_pz_zeta0_points: the polarized form at zeta = 0 with every term that is
// exactly zero or an exact duplicate there left out (one pow and two cbrt a
// point in place of four pow and five cbrt, constants aside; one PZ channel
// in place of two), each remaining expression written operand for operand
// as x_pz writes it, so the compiler contracts the same multiply-adds. For
// finite densities its e and v are the bits of lda_xc_points' e and v_up
// at (rho/2, rho/2): zeta = 0/n = +0, pow(1, 4/3) = 1 and
// cbrt(1) - cbrt(1) = 0 exactly, so f(zeta) = f'(zeta) = 0 and eps,
// deps/drs are the unpolarized channel's own; the two exchange powers are
// equal, v_up = v_dn, and (v_up + v_dn)/2 = v_up. The entry picks the
// kernel; lda_xc_points serves every other launch.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "xc_dual.cuh"

namespace {

using xc::kDensTh;
using xc::kPi;
using xc::kTiny;

struct Pz {
    double eps, deps;  // eps_c(rs) and d eps_c / d rs
};

__device__ Pz pz_eps(double rs, bool pol) {
    double gamma, b1, b2, a, b, c, d;
    if (pol) {
        gamma = -0.0843; b1 = 1.3981; b2 = 0.2611;
        a = 0.01555; b = -0.0269; c = 0.0007; d = -0.0048;
    } else {
        gamma = -0.1423; b1 = 1.0529; b2 = 0.3334;
        a = 0.0311; b = -0.048; c = 0.002; d = -0.0116;
    }
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

// e, v_up, v_dn at one point (inputs already thresholded).
__device__ void x_pz(double nu, double nd, double* e, double* vu, double* vd) {
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
    const Pz u = pz_eps(rs, false);
    const Pz p = pz_eps(rs, true);
    const double fden = pow(2.0, 4.0 / 3.0) - 2.0;
    const double fz = (pow(1.0 + zeta, 4.0 / 3.0) + pow(1.0 - zeta, 4.0 / 3.0) - 2.0) / fden;
    const double dfz = (4.0 / 3.0) * (cbrt(1.0 + zeta) - cbrt(1.0 - zeta)) / fden;
    const double eps = u.eps + fz * (p.eps - u.eps);
    const double deps_drs = u.deps + fz * (p.deps - u.deps);
    const double deps_dz = dfz * (p.eps - u.eps);
    const double common = eps - rs / 3.0 * deps_drs;
    *e = ex + n * eps;
    *vu = vxu + common + (1.0 - zeta) * deps_dz;
    *vd = vxd + common - (1.0 + zeta) * deps_dz;
}

// x_pz at nu = nd = nh (thresholded): e and v = v_up = v_dn
__device__ void x_pz_zeta0(double nh, double* e, double* v) {
    nh = fmax(nh, kTiny);
    const double cx = 0.75 * cbrt(3.0 / kPi);
    const double px = pow(2.0 * nh, 4.0 / 3.0);
    const double ex = -cx / 2.0 * (px + px);
    const double vx = -(4.0 / 3.0) * cx * cbrt(2.0 * nh);
    const double n = nh + nh;
    const double rs = cbrt(3.0 / (4.0 * kPi * n));
    const Pz u = pz_eps(rs, false);
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
        if (mask == (xc::kLdaX | xc::kLdaCPz))
            x_pz(up0 ? kDensTh : nu, dn0 ? kDensTh : nd, &e, &vu, &vd);
        else
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

}  // namespace

// Polarized: nu, nd -> e, vu, vd. Unpolarized (unpolarized != 0): nu holds
// rho, nd and vd are unused, vu receives v = (v_up + v_dn) / 2. mask: the
// functionals summed (LDA bits of xc_dual.cuh only; any other mask returns
// cudaErrorInvalidValue without a launch).
extern "C" int lda_xc(const double* nu, const double* nd, double* e, double* vu,
                      double* vd, long long n, int unpolarized, int mask,
                      void* stream) {
    if (mask == 0 || (mask & ~xc::kLdaBits)) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks <= 0) return (int)cudaGetLastError();
    if (unpolarized && mask == (xc::kLdaX | xc::kLdaCPz))
        x_pz_zeta0_points<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            nu, e, vu, n);
    else
        lda_xc_points<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            nu, nd, e, vu, vd, n, unpolarized, mask);
    return (int)cudaGetLastError();
}
