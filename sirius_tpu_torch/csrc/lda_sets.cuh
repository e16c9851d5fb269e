// The LDA functional sets the port's decks run besides X + PZ, Slater
// exchange plus PW92 or VWN5 correlation (XC_LDA_X with XC_LDA_C_PW or
// XC_LDA_C_VWN), written for their own kernel instantiations of lda_xc.cu.
// Every other LDA list keeps the runtime-mask energy of xc_dual.cuh.
//
// They compute what xc_dual.cuh's lda_x_e, lda_c_pw_e (the published
// digits, mod = false) and lda_c_vwn_e compute (the JAX package's
// sirius_tpu/dft/xc.py:33-36, :73-133) and the derivatives jax.grad takes
// of them, with changes that leave the values alone up to rounding:
//
// - every power is a cube root or a square root: each exchange half
//   (2 n_s)^(4/3) from (2 n_s)^(1/3), rs = kRsK / n^(1/3), f(zeta) from
//   (1 +- zeta)^(1/3) (xc_sets.cuh's zeta_f_c), which give f'(zeta) too;
//   xc_dual.cuh's dpow runs two fp64 pow calls;
// - shared pieces are evaluated once: sqrt(rs) serves the three PW92
//   channels, x = sqrt(rs) and 1/x the three VWN channels;
// - only the partials a term depends on are carried: each exchange half is
//   a function of its own n_s, each correlation channel of rs alone (on
//   Dual<1> over rs), f(zeta) and zeta^4 of zeta alone; the correlation
//   energy n eps(rs, zeta) gives v_up and v_dn by the chain rule
//   eps - rs/3 deps/drs +- (1 -+ zeta) deps/dzeta, as x_pz does;
// - a VWN channel's slope is the closed form of the derivative of its
//   three terms, dF/dx = (2a / X(x)) (c / x - b x0 / (x - x0)).
//
// The unpolarized instantiation evaluates n_up = n_dn = rho/2 at zeta = 0,
// where f(zeta) and its slope are exactly 0: eps_c is the ec0 channel alone
// (alpha_c f / f''(0) (1 - z^4) and (ec1 - ec0) f z^4 add +-0) and the
// exchange halves are one, -cx n^(4/3) on n = rho, whose cube root is rs's.
//
// The callers sanitize dead channels first (n_s >= _DENS_TH, xc.py:350-356),
// so the _TINY floors (xc.py:329-330) select their first argument and are
// left out.
#pragma once

#include "xc_sets.cuh"

namespace xc {

// (3/4) (3/pi)^(1/3) of Slater exchange
constexpr double kCx = 0.7385587663820223;

// one spin channel's exchange, (-cx/2) m^(4/3) at m = 2 n_s (xc.py:33-36),
// from m^(1/3): the energy and its slope in n_s
struct Half {
    double e, v;
};

__device__ __forceinline__ Half lda_x_half(double ns) {
    const double m = 2.0 * ns;
    const double c = cbrt(m);
    return {(-0.5 * kCx) * (m * c), (-(4.0 / 3.0) * kCx) * c};
}

// PW92 with the published digits (xc.py:84-97, mod=False): the three
// channels from rs and its square root
struct Pw92Set {
    template <int N>
    static __device__ __forceinline__ Dual<N> ec0(const Dual<N>& rs, const Dual<N>& s) {
        return pw92_gs(rs, s, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294);
    }
    template <int N>
    static __device__ __forceinline__ void channels(const Dual<N>& rs, const Dual<N>& s,
                                                    Dual<N>* e0, Dual<N>* e1, Dual<N>* ac) {
        *e0 = ec0(rs, s);
        *e1 = pw92_gs(rs, s, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517);
        // the spin-stiffness fit parametrizes -alpha_c: POSITIVE sign below
        *ac = -pw92_gs(rs, s, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671);
    }
};

// the VWN5 channels (xc.py:100-114): a, x0, b, c of each fit, and
// q = sqrt(4c - b^2), 2b/q, b x0 / X(x0) and 2 (b + 2 x0)/q as the JAX
// package derives them
struct Vwn0 {
    static constexpr double a = 0.0310907, x0 = -0.10498, b = 3.72744, c = 12.9352;
    static constexpr double q = 6.15199081975908, bq2 = 1.2117833427280607,
                            bx0 = -0.031167608678943783, bx0q2 = 1.1435257636284148;
};
struct Vwn1 {
    static constexpr double a = 0.01554535, x0 = -0.325, b = 7.06042, c = 18.0578;
    static constexpr double q = 4.730926909560114, bq2 = 2.9847935235408167,
                            bx0 = -0.14460061018520728, bx0q2 = 2.710005934374516;
};
// alpha_c, a = -1 / (6 pi^2)
struct VwnA {
    static constexpr double a = -0.01688686394038963, x0 = -0.0047584, b = 1.13107,
                            c = 13.0045;
    static constexpr double q = 7.123108917818118, bq2 = 0.31757762321187655,
                            bx0 = -0.0004140337942820628, bx0q2 = 0.31490553154241063;
};

// channel K's F(x) at x = sqrt(rs), ix = 1/x, with its slope in rs,
// dF/drs = dF/dx / (2x)
template <class K, int N>
__device__ __forceinline__ Dual<N> vwn_gx(const Dual<N>& rs, double x, double ix) {
    const double xx = x * x + K::b * x + K::c;
    const double ixx = 1.0 / xx;
    const double dx0 = x - K::x0;
    const double atn = atan(K::q / (2.0 * x + K::b));
    const double f = K::a * (log(x * x * ixx) + K::bq2 * atn -
                             K::bx0 * (log(dx0 * dx0 * ixx) + K::bx0q2 * atn));
    const double df_dx = (2.0 * K::a) * ixx * (K::c * ix - (K::b * K::x0) / dx0);
    return chain(rs, f, 0.5 * ix * df_dx);
}

// VWN5 (xc.py:117-133): the three channels from rs and x = sqrt(rs)
struct VwnSet {
    template <int N>
    static __device__ __forceinline__ Dual<N> ec0(const Dual<N>& rs, const Dual<N>& s) {
        return vwn_gx<Vwn0>(rs, s.v, 1.0 / s.v);
    }
    template <int N>
    static __device__ __forceinline__ void channels(const Dual<N>& rs, const Dual<N>& s,
                                                    Dual<N>* e0, Dual<N>* e1, Dual<N>* ac) {
        const double ix = 1.0 / s.v;
        *e0 = vwn_gx<Vwn0>(rs, s.v, ix);
        *e1 = vwn_gx<Vwn1>(rs, s.v, ix);
        *ac = vwn_gx<VwnA>(rs, s.v, ix);
    }
};

// e, v_up, v_dn of exchange + the set's correlation at one sanitized point
template <class Set>
__device__ __forceinline__ void lda_set_point(double nu, double nd, double* e, double* vu,
                                              double* vd) {
    using D = Dual<1>;
    const Half xu = lda_x_half(nu);
    const Half xd = lda_x_half(nd);
    const double n = nu + nd;
    const double zeta = fmin(fmax((nu - nd) / n, -1.0), 1.0);
    const double rs_v = kRsK / cbrt(n);
    const D rs = seed<1>(rs_v, 0);
    D e0, e1, ac;
    Set::channels(rs, dsqrt(rs), &e0, &e1, &ac);
    // f(zeta), f'(zeta) and zeta^4 (xc_sets.cuh's zeta_f_c on values)
    const double cp = cbrt(1.0 + zeta);
    const double cm = cbrt(1.0 - zeta);
    const double fz = ((1.0 + zeta) * cp + (1.0 - zeta) * cm - 2.0) * (1.0 / kFzDen);
    const double dfz = (4.0 / 3.0) * (cp - cm) * (1.0 / kFzDen);
    const double z2 = zeta * zeta;
    const double z4 = z2 * z2;
    const double dz4 = 4.0 * z2 * zeta;
    // eps = ec0 + alpha_c f / f''(0) (1 - z^4) + (ec1 - ec0) f z^4, its
    // value and slope in rs on the dual, its slope in zeta by hand
    const D a = ac * (1.0 / kFpp0);
    const D d = e1 - e0;
    const D eps = e0 + a * (fz * (1.0 - z4)) + d * (fz * z4);
    const double deps_dz = a.v * (dfz * (1.0 - z4) - fz * dz4) + d.v * (dfz * z4 + fz * dz4);
    const double common = eps.v - rs_v / 3.0 * eps.d[0];
    *e = (xu.e + xd.e) + n * eps.v;
    *vu = xu.v + common + (1.0 - zeta) * deps_dz;
    *vd = xd.v + common - (1.0 + zeta) * deps_dz;
}

// e and v = de/drho of exchange + the set's correlation at n_up = n_dn =
// rho/2, from the sanitized half density nh
template <class Set>
__device__ __forceinline__ void lda_set_point_zeta0(double nh, double* e, double* v) {
    using D = Dual<1>;
    const double n = nh + nh;
    const double cn = cbrt(n);
    const double rs_v = kRsK / cn;
    const D rs = seed<1>(rs_v, 0);
    const D e0 = Set::ec0(rs, dsqrt(rs));
    *e = (-kCx) * (n * cn) + n * e0.v;
    *v = (-(4.0 / 3.0) * kCx) * cn + (e0.v - rs_v / 3.0 * e0.d[0]);
}

}  // namespace xc
