// The functional sets the port's decks run, PBE, PBEsol and SCAN exchange
// plus correlation, written for their own kernel instantiations
// (gga_xc.cu, mgga_xc.cu). Every other legal list keeps the runtime-mask
// energy of xc_dual.cuh.
//
// They compute what xc_dual.cuh's expressions compute (the JAX package's
// sirius_tpu/dft/xc.py:141-182 and :205-297), on the same dual numbers,
// with three changes that leave the values alone up to rounding:
//
// - every power is a cube root or a square root: x^(k/3) from one cbrt
//   (x^(2/3) = c^2, x^(4/3) = x c, x^(5/3) = x c^2) and x^(-1/4) from
//   rsqrt(sqrt(x)), the slope taken from the value; xc_dual.cuh's dpow
//   runs two fp64 pow calls, each several times a cbrt (polarized
//   PBE-family exchange keeps dpow: gga_xc.cu::point_polarized says why);
// - shared pieces are evaluated once: n^(1/3) gives rs and kF (and, at
//   zeta = 0, exchange's kF too), sqrt(rs) serves the three PW92 channels
//   and SCAN's eps_c^0, and (1 +- zeta)^(1/3) serves phi, f(zeta) and
//   SCAN's d_s and d_x;
// - the caller seeds only the partials a term depends on: PBE and SCAN
//   exchange are spin-scaled, so each half is a function of (n_s,
//   sigma_ss [, tau_s]); correlation reads (n_up, n_dn, sigma [, tau]) with
//   sigma = sigma_uu + 2 sigma_ud + sigma_dd.
//
// kZeta0 specializes the unpolarized evaluation, n_up = n_dn = rho/2, at
// zeta = 0. There zeta, its partials and f(zeta) are exactly 0 and phi,
// d_s, d_x and g_c exactly 1, so each term that is exactly 1 or 0 in the
// polarized expression is that constant here: PW92's eps_c is its ec0
// channel (mac f / f''(0) (1 - z^4) and (ec1 - ec0) f z^4 add +-0), and
// products with phi^k, d_s or g_c are the products without them.
//
// The callers sanitize dead channels first (n_s >= _DENS_TH, xc.py:350-356),
// so the _TINY floors on n and n_s (xc.py:329-330, :225, :247) select their
// first argument here and are written as the plain arguments.
#pragma once

#include "xc_dual.cuh"

namespace xc {

// (3 / (4 pi))^(1/3), (3 pi^2)^(1/3): rs = kRsK / n^(1/3), kF = kKfK n^(1/3)
constexpr double kRsK = 0.6203504908994001;
constexpr double kKfK = 3.0936677262801355;
// 2^(4/3) - 2 and f''(0) = 8 / (9 (2^(4/3) - 2)) of f(zeta)
constexpr double kFzDen = 0.5198420997897464;
constexpr double kFpp0 = 1.7099209341613653;
// PBE's gamma = (1 - ln 2) / pi^2
constexpr double kPbeGamma = 0.0310906908696549;
// SCAN: 0.3 (3 pi^2)^(2/3), (3 pi^2 / 16)^(2/3), and b1, b2, b4 of
// exchange as xc.py:192-195 derives them
constexpr double kScanTauU = 2.871234000188191;
constexpr double kScanT2K = 1.5073033983379012;
constexpr double kScanB1 = 0.15663207743548518;
constexpr double kScanB2 = 0.12083045973594572;
constexpr double kScanB4 = 0.12183151020599578;

struct PbeSet {
    static constexpr double kMu = kPbeMu;
    static constexpr double kBeta = kPbeBeta;
};
struct PbeSolSet {
    static constexpr double kMu = kPbeSolMu;
    static constexpr double kBeta = kPbeSolBeta;
};

// x^(1/3), its slope from its value
template <int N>
__device__ __forceinline__ Dual<N> dcbrt(const Dual<N>& x) {
    const double c = cbrt(x.v);
    return chain(x, c, c / (3.0 * x.v));
}

// x^(-1/4), its slope from its value
template <int N>
__device__ __forceinline__ Dual<N> drqrt(const Dual<N>& x) {
    const double r = rsqrt(sqrt(x.v));
    return chain(x, r, -0.25 * r / x.v);
}

// one PW92 channel G(rs) (xc.py:65-68) from rs and its square root
template <int N>
__device__ __forceinline__ Dual<N> pw92_gs(const Dual<N>& rs, const Dual<N>& s,
                                           double a, double a1, double b1,
                                           double b2, double b3, double b4) {
    const Dual<N> den = (2.0 * a) * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs);
    return (-2.0 * a) * (1.0 + a1 * rs) * dlog1p(1.0 / den);
}

// PW_MOD eps_c per particle (xc.py:71-97) at zeta = 0: the ec0 channel
template <int N>
__device__ __forceinline__ Dual<N> pw_mod_eps0(const Dual<N>& rs, const Dual<N>& s) {
    return pw92_gs(rs, s, 0.0310907, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294);
}

// PW_MOD eps_c per particle at any zeta, f(zeta) given
template <int N>
__device__ Dual<N> pw_mod_eps(const Dual<N>& rs, const Dual<N>& s,
                              const Dual<N>& zeta, const Dual<N>& fz) {
    const Dual<N> ec0 = pw_mod_eps0(rs, s);
    const Dual<N> ec1 = pw92_gs(rs, s, 0.01554535, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517);
    // the spin-stiffness fit parametrizes -alpha_c: POSITIVE sign below
    const Dual<N> mac = -pw92_gs(rs, s, 0.0168869, 0.11125, 10.357, 3.6231, 0.88026, 0.49671);
    const Dual<N> z2 = zeta * zeta;
    const Dual<N> z4 = z2 * z2;
    return ec0 + mac * fz * (1.0 / kFpp0) * (1.0 - z4) + (ec1 - ec0) * fz * z4;
}

// f(zeta) from cp = (1 + zeta)^(1/3), cm = (1 - zeta)^(1/3)
template <int N>
__device__ __forceinline__ Dual<N> zeta_f_c(const Dual<N>& zeta, const Dual<N>& cp,
                                            const Dual<N>& cm) {
    return ((1.0 + zeta) * cp + (1.0 - zeta) * cm - 2.0) * (1.0 / kFzDen);
}

// PBE-family exchange of one fully polarized channel (xc.py:151-158):
// n2 = 2 n_s, kf = (3 pi^2 n2)^(1/3), sigma4 = 4 sigma_ss
template <int N>
__device__ __forceinline__ Dual<N> pbe_x_half_k(const Dual<N>& n2, const Dual<N>& kf,
                                                const Dual<N>& sigma4, double mu) {
    const Dual<N> ex_lda = (-(3.0 / (4.0 * kPi))) * kf * n2;
    const Dual<N> s2 = sigma4 / dfloor(4.0 * dsq(kf) * dsq(n2), kTiny);
    const Dual<N> fx = (1.0 + kPbeKappa) - kPbeKappa / (1.0 + mu * s2 * (1.0 / kPbeKappa));
    return ex_lda * fx;
}

// PBE-family correlation (xc.py:166-182) on (n_up, n_dn, sigma), with
// n = n_up + n_dn and cn = n^(1/3) given
template <bool kZeta0, int N>
__device__ Dual<N> pbe_c_k(const Dual<N>& nu, const Dual<N>& nd, const Dual<N>& sigma,
                           const Dual<N>& n, const Dual<N>& cn, double beta) {
    const Dual<N> rs = kRsK / cn;
    const Dual<N> srs = dsqrt(rs);
    const Dual<N> kf = kKfK * cn;
    const Dual<N> ks = dsqrt(4.0 * kf * (1.0 / kPi));
    Dual<N> eps, t2, gphi3;
    if constexpr (kZeta0) {
        eps = pw_mod_eps0(rs, srs);
        t2 = sigma / dfloor(dsq(2.0 * ks * n), kTiny);
        gphi3 = constant<N>(kPbeGamma);
    } else {
        const Dual<N> zeta = dclip((nu - nd) / n, -1.0, 1.0);
        const Dual<N> cp = dcbrt(1.0 + zeta);
        const Dual<N> cm = dcbrt(1.0 - zeta);
        eps = pw_mod_eps(rs, srs, zeta, zeta_f_c(zeta, cp, cm));
        const Dual<N> phi = 0.5 * (dsq(cp) + dsq(cm));
        t2 = sigma / dfloor(dsq(2.0 * phi * ks * n), kTiny);
        gphi3 = kPbeGamma * (phi * phi * phi);
    }
    const Dual<N> a_den = dexp(-eps / gphi3) - 1.0;
    const Dual<N> aa = (beta / kPbeGamma) / dfloor(a_den, kTiny);
    const Dual<N> num = 1.0 + aa * t2;
    const Dual<N> h = gphi3 * dlog1p((beta / kPbeGamma) * t2 * num /
                                     (1.0 + aa * t2 + dsq(aa) * dsq(t2)));
    return n * (eps + h);
}

// SCAN exchange of one fully polarized channel (xc.py:221-242): n2 = 2 n_s
// (after its _TINY floor), cn2 = n2^(1/3), den = max(4 kF^2 n2^2, _TINY)
template <int N>
__device__ Dual<N> scan_x_half_k(const Dual<N>& n2, const Dual<N>& kf,
                                 const Dual<N>& n53, const Dual<N>& den,
                                 const Dual<N>& sigma4, const Dual<N>& tau2) {
    const Dual<N> ex_lda = (-(3.0 / (4.0 * kPi))) * kf * n2;
    const Dual<N> s2 = sigma4 / den;
    const Dual<N> s = dsqrt(dmaximum(s2, kTiny));
    const Dual<N> tau_w = sigma4 / (8.0 * n2);
    const Dual<N> tau_u = kScanTauU * n53;
    const Dual<N> alpha = dmaximum(tau2 - tau_w, 0.0) / dmaximum(tau_u, kTiny);
    const Dual<N> oma = 1.0 - alpha;
    const Dual<N> x =
        kScanMu * s2 * (1.0 + (kScanB4 * s2 * (1.0 / kScanMu)) *
                                  dexp((-kScanB4) * s2 * (1.0 / kScanMu))) +
        dsq(kScanB1 * s2 + kScanB2 * oma * dexp((-kScanB3) * dsq(oma)));
    const Dual<N> h1x = (1.0 + kScanK1) - kScanK1 / (1.0 + x * (1.0 / kScanK1));
    const Dual<N> fx = scan_interp(alpha, kScanC1x, kScanC2x, kScanDx);
    const Dual<N> gx = 1.0 - dexp((-kScanA1) / dsqrt(s));
    return ex_lda * ((h1x + fx * (kScanH0x - h1x)) * gx);
}

// SCAN correlation (xc.py:245-297) on (n_up, n_dn, sigma, tau), with n =
// max(n_up + n_dn, _TINY), cn = n^(1/3), n53 = n^(5/3) and den = max(4 kF^2
// n^2, _TINY) given. PW92 takes zeta clipped to [-1, 1], the rest of SCAN
// to +-0.999999 (xc.py:247, :86): the two share (1 +- zeta)^(1/3) wherever
// the narrower clip selects zeta itself
template <bool kZeta0, int N>
__device__ Dual<N> scan_c_k(const Dual<N>& nu, const Dual<N>& nd, const Dual<N>& sigma,
                            const Dual<N>& tau, const Dual<N>& n, const Dual<N>& cn,
                            const Dual<N>& n53, const Dual<N>& den) {
    const Dual<N> rs = kRsK / cn;
    const Dual<N> srs = dsqrt(rs);
    const Dual<N> s2 = sigma / den;
    const Dual<N> tau_w = sigma / (8.0 * n);
    Dual<N> eps_lsda, tau_u, phi2, phi3, gc;
    if constexpr (kZeta0) {
        eps_lsda = pw_mod_eps0(rs, srs);
        tau_u = kScanTauU * n53;
    } else {
        const Dual<N> zpw = dclip((nu - nd) / n, -1.0, 1.0);
        const Dual<N> zeta = dclip(zpw, -0.999999, 0.999999);
        const Dual<N> opz = 1.0 + zeta;
        const Dual<N> omz = 1.0 - zeta;
        const Dual<N> cp = dcbrt(opz);
        const Dual<N> cm = dcbrt(omz);
        const bool same = zpw.v >= -0.999999 && zpw.v <= 0.999999;
        const Dual<N> fz = same ? zeta_f_c(zpw, cp, cm)
                                : zeta_f_c(zpw, dcbrt(1.0 + zpw), dcbrt(1.0 - zpw));
        eps_lsda = pw_mod_eps(rs, srs, zpw, fz);
        const Dual<N> cp2 = dsq(cp);
        const Dual<N> cm2 = dsq(cm);
        tau_u = kScanTauU * n53 * (0.5 * (opz * cp2 + omz * cm2));
        const Dual<N> phi = 0.5 * (cp2 + cm2);
        phi2 = dsq(phi);
        phi3 = phi * phi2;
        const Dual<N> dxz = 0.5 * (opz * cp + omz * cm);
        const Dual<N> z2 = zeta * zeta;
        const Dual<N> z4 = z2 * z2;
        const Dual<N> z12 = z4 * (z4 * z4);
        gc = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - z12);
    }
    const Dual<N> alpha = dmaximum(tau - tau_w, 0.0) / dmaximum(tau_u, kTiny);

    // eps_c^1: PW92 + H1 (PBE-like with an rs-dependent beta)
    const Dual<N> beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs);
    const Dual<N> t2 = kZeta0 ? kScanT2K * s2 / dmaximum(rs, kTiny)
                              : kScanT2K * s2 / dmaximum(phi2 * rs, kTiny);
    const Dual<N> gphi3 = kZeta0 ? constant<N>(kScanGamma) : kScanGamma * phi3;
    const Dual<N> w1 = dexpm1(-eps_lsda / gphi3);
    const Dual<N> y = beta_rs / (kScanGamma * dmaximum(w1, kTiny)) * t2;
    const Dual<N> gy = drqrt(1.0 + 4.0 * y);
    const Dual<N> h1 = gphi3 * dlog1p(w1 * (1.0 - gy));
    const Dual<N> eps1 = eps_lsda + h1;

    // eps_c^0: the low-density limit + H0
    const Dual<N> eps_lda0 = (-kScanB1c) / (1.0 + kScanB2c * srs + kScanB3c * rs);
    const Dual<N> w0 = dexpm1(-eps_lda0 * (1.0 / kScanB1c));
    const Dual<N> ginf = drqrt(1.0 + (4.0 * kScanChi) * s2);
    const Dual<N> h0 = kScanB1c * dlog1p(w0 * (1.0 - ginf));
    const Dual<N> eps0 = kZeta0 ? eps_lda0 + h0 : (eps_lda0 + h0) * gc;

    const Dual<N> fc = scan_interp(alpha, kScanC1c, kScanC2c, kScanDc);
    return n * (eps1 + fc * (eps0 - eps1));
}

// SCAN exchange of spin channel s, 0.5 X(2 n_s, 4 sigma_ss, 2 tau_s) before
// the 0.5, on duals seeded by the caller
template <int N>
__device__ __forceinline__ Dual<N> scan_x_channel(const Dual<N>& ns, const Dual<N>& sss,
                                                  const Dual<N>& ts) {
    const Dual<N> n2 = dmaximum(2.0 * ns, kTiny);
    const Dual<N> cn2 = dcbrt(n2);
    const Dual<N> kf = kKfK * cn2;
    return scan_x_half_k(n2, kf, n2 * dsq(cn2),
                         dmaximum(4.0 * dsq(kf) * dsq(n2), kTiny), 4.0 * sss,
                         2.0 * ts);
}

}  // namespace xc
