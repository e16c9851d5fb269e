// Forward-mode dual numbers and the exchange-correlation energies of the
// port, written once as templates over them.
//
// The JAX package defines every functional as an energy per volume
// e(n_up, n_dn, sigma_uu, sigma_ud, sigma_dd) and takes the potentials from
// jax.grad (sirius_tpu/dft/xc.py:23-182). Here the same expressions run on
// Dual<N>: a value and its N partial derivatives, carried through + - * /,
// pow, sqrt, log, log1p, exp and atan by the chain rule. Evaluating the
// energy once on duals seeded with the inputs' unit vectors gives the exact
// derivatives jax.grad gives, without hand-written derivative formulas for
// PBE correlation. The selections of the JAX code (jnp.clip, jnp.maximum
// against a constant, jnp.where on a branch) propagate the derivative of
// the branch they select, as they do under jax.grad.
//
// Included by lda_xc.cu (K7, Dual<2> over n_up, n_dn), gga_xc.cu (K7g,
// Dual<5> polarized, Dual<2> over rho, sigma unpolarized) and mgga_xc.cu
// (K7s: SCAN exchange on Dual<3> per spin channel, SCAN correlation on
// Dual<4>, Dual<3> over rho, sigma, tau unpolarized).
#pragma once

#include <cuda_runtime.h>

namespace xc {

constexpr double kPi = 3.141592653589793;
constexpr double kTiny = 1e-25;     // xc.py _TINY
constexpr double kDensTh = 1e-13;   // xc.py _DENS_TH

// functional bits, in the order of kernels/xc_functionals.py FUNC_BITS
enum : int {
    kLdaX = 1,
    kLdaCPz = 2,
    kLdaCPw = 4,
    kLdaCVwn = 8,
    kGgaXPbe = 16,
    kGgaCPbe = 32,
    kGgaXPbeSol = 64,
    kGgaCPbeSol = 128,
    kMggaXScan = 256,
    kMggaCScan = 512,
    kLdaBits = kLdaX | kLdaCPz | kLdaCPw | kLdaCVwn,
    kLdaGgaBits = 255,
    kMggaBits = kMggaXScan | kMggaCScan,
};

constexpr double kPbeKappa = 0.804;
constexpr double kPbeMu = 0.2195149727645171;
constexpr double kPbeBeta = 0.06672455060314922;
constexpr double kPbeSolMu = 10.0 / 81.0;
constexpr double kPbeSolBeta = 0.046;

// SCAN (xc.py:190-203); B2, B1 and B4 as the JAX package derives them
constexpr double kScanK1 = 0.065;
constexpr double kScanMu = 10.0 / 81.0;
constexpr double kScanB3 = 0.5;
constexpr double kScanH0x = 1.174;
constexpr double kScanA1 = 4.9479;
constexpr double kScanC1x = 0.667, kScanC2x = 0.8, kScanDx = 1.24;
constexpr double kScanC1c = 0.64, kScanC2c = 1.5, kScanDc = 0.7;
constexpr double kScanB1c = 0.0285764, kScanB2c = 0.0889, kScanB3c = 0.125541;
constexpr double kScanChi = 0.12802585262625815;
constexpr double kScanGamma = 0.031091;

template <int N>
struct Dual {
    double v;
    double d[N];
};

template <int N>
__device__ __forceinline__ Dual<N> constant(double c) {
    Dual<N> r;
    r.v = c;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = 0.0;
    return r;
}

// a value whose derivative is `slope` along input k
template <int N>
__device__ __forceinline__ Dual<N> seed(double x, int k, double slope = 1.0) {
    Dual<N> r = constant<N>(x);
    r.d[k] = slope;
    return r;
}

// y = f(x) with f'(x) = df
template <int N>
__device__ __forceinline__ Dual<N> chain(const Dual<N>& x, double f, double df) {
    Dual<N> r;
    r.v = f;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = df * x.d[i];
    return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
    Dual<N> r;
    r.v = a.v + b.v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
    return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
    Dual<N> r;
    r.v = a.v - b.v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
    return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
    Dual<N> r;
    r.v = a.v * b.v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
    return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
    Dual<N> r;
    r.v = a.v / b.v;
    const double inv = 1.0 / b.v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
    return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
    return chain(a, -a.v, -1.0);
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, double c) {
    Dual<N> r = a;
    r.v = a.v + c;
    return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(double c, const Dual<N>& a) {
    return a + c;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, double c) {
    Dual<N> r = a;
    r.v = a.v - c;
    return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(double c, const Dual<N>& a) {
    return chain(a, c - a.v, -1.0);
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, double c) {
    return chain(a, a.v * c, c);
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(double c, const Dual<N>& a) {
    return chain(a, c * a.v, c);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, double c) {
    return chain(a, a.v / c, 1.0 / c);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(double c, const Dual<N>& a) {
    const double v = c / a.v;
    return chain(a, v, -v / a.v);
}

template <int N>
__device__ __forceinline__ Dual<N> dpow(const Dual<N>& x, double p) {
    return chain(x, pow(x.v, p), p * pow(x.v, p - 1.0));
}
template <int N>
__device__ __forceinline__ Dual<N> dsq(const Dual<N>& x) {
    return x * x;
}
template <int N>
__device__ __forceinline__ Dual<N> dsqrt(const Dual<N>& x) {
    const double s = sqrt(x.v);
    return chain(x, s, 0.5 / s);
}
template <int N>
__device__ __forceinline__ Dual<N> dlog(const Dual<N>& x) {
    return chain(x, log(x.v), 1.0 / x.v);
}
template <int N>
__device__ __forceinline__ Dual<N> dlog1p(const Dual<N>& x) {
    return chain(x, log1p(x.v), 1.0 / (1.0 + x.v));
}
template <int N>
__device__ __forceinline__ Dual<N> dexp(const Dual<N>& x) {
    const double e = exp(x.v);
    return chain(x, e, e);
}
template <int N>
__device__ __forceinline__ Dual<N> dexpm1(const Dual<N>& x) {
    const double e = expm1(x.v);
    return chain(x, e, e + 1.0);
}
template <int N>
__device__ __forceinline__ Dual<N> datan(const Dual<N>& x) {
    return chain(x, atan(x.v), 1.0 / (1.0 + x.v * x.v));
}
// max(x, lo) against a constant: the derivative of the selected branch
// (the plain version's torch.clamp passes it where x >= lo)
template <int N>
__device__ __forceinline__ Dual<N> dfloor(const Dual<N>& x, double lo) {
    return x.v >= lo ? x : constant<N>(lo);
}
// jnp.maximum(x, c) against a constant, as jax.grad differentiates it: the
// slope of the selected branch, split in half at a tie
template <int N>
__device__ __forceinline__ Dual<N> dmaximum(const Dual<N>& x, double c) {
    if (x.v > c) return x;
    if (x.v < c) return constant<N>(c);
    return chain(x, c, 0.5);
}
template <int N>
__device__ __forceinline__ Dual<N> dclip(const Dual<N>& x, double lo, double hi) {
    if (x.v < lo) return constant<N>(lo);
    if (x.v > hi) return constant<N>(hi);
    return x;
}

// ---- the energies per volume (sirius_tpu/dft/xc.py) ----

template <int N>
__device__ Dual<N> lda_x_e(const Dual<N>& nu, const Dual<N>& nd) {
    const double cx = (3.0 / 4.0) * pow(3.0 / kPi, 1.0 / 3.0);
    return (-cx / 2.0) * (dpow(2.0 * nu, 4.0 / 3.0) + dpow(2.0 * nd, 4.0 / 3.0));
}

template <int N>
__device__ void zeta_rs(const Dual<N>& nu, const Dual<N>& nd, Dual<N>* n,
                        Dual<N>* zeta, Dual<N>* rs) {
    *n = nu + nd;
    *zeta = dclip((nu - nd) / *n, -1.0, 1.0);
    *rs = dpow(3.0 / ((4.0 * kPi) * *n), 1.0 / 3.0);
}

template <int N>
__device__ Dual<N> zeta_f(const Dual<N>& zeta) {
    return (dpow(1.0 + zeta, 4.0 / 3.0) + dpow(1.0 - zeta, 4.0 / 3.0) - 2.0) /
           (pow(2.0, 4.0 / 3.0) - 2.0);
}

template <int N>
__device__ Dual<N> pz_eps(const Dual<N>& rs, bool pol) {
    double gamma, b1, b2, a, b, c, d;
    if (pol) {
        gamma = -0.0843; b1 = 1.3981; b2 = 0.2611;
        a = 0.01555; b = -0.0269; c = 0.0007; d = -0.0048;
    } else {
        gamma = -0.1423; b1 = 1.0529; b2 = 0.3334;
        a = 0.0311; b = -0.048; c = 0.002; d = -0.0116;
    }
    if (rs.v >= 1.0) return gamma / (1.0 + b1 * dsqrt(rs) + b2 * rs);
    const Dual<N> lrs = dlog(rs);
    return a * lrs + b + c * rs * lrs + d * rs;
}

template <int N>
__device__ Dual<N> lda_c_pz_e(const Dual<N>& nu, const Dual<N>& nd) {
    Dual<N> n, zeta, rs;
    zeta_rs(nu, nd, &n, &zeta, &rs);
    const Dual<N> eu = pz_eps(rs, false);
    const Dual<N> ep = pz_eps(rs, true);
    return n * (eu + zeta_f(zeta) * (ep - eu));
}

template <int N>
__device__ Dual<N> pw92_g(const Dual<N>& rs, double a, double a1, double b1,
                          double b2, double b3, double b4) {
    const Dual<N> s = dsqrt(rs);
    const Dual<N> den = (2.0 * a) * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs);
    return (-2.0 * a) * (1.0 + a1 * rs) * dlog1p(1.0 / den);
}

template <int N>
__device__ Dual<N> lda_c_pw_e(const Dual<N>& nu, const Dual<N>& nd, bool mod) {
    Dual<N> n, zeta, rs;
    zeta_rs(nu, nd, &n, &zeta, &rs);
    // PW_MOD (the parametrization PBE correlation is defined on) carries one
    // more digit on the A coefficients than the published PW92
    const double a0 = mod ? 0.0310907 : 0.031091;
    const double a1 = mod ? 0.01554535 : 0.015545;
    const double a2 = mod ? 0.0168869 : 0.016887;
    const Dual<N> ec0 = pw92_g(rs, a0, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294);
    const Dual<N> ec1 = pw92_g(rs, a1, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517);
    // the spin-stiffness fit parametrizes -alpha_c: POSITIVE sign below
    const Dual<N> mac = -pw92_g(rs, a2, 0.11125, 10.357, 3.6231, 0.88026, 0.49671);
    const Dual<N> fz = zeta_f(zeta);
    const double fpp0 = 8.0 / (9.0 * (pow(2.0, 4.0 / 3.0) - 2.0));
    const Dual<N> z2 = zeta * zeta;
    const Dual<N> z4 = z2 * z2;
    const Dual<N> eps = ec0 + mac * fz / fpp0 * (1.0 - z4) + (ec1 - ec0) * fz * z4;
    return n * eps;
}

template <int N>
__device__ Dual<N> vwn_f(const Dual<N>& rs, double a, double x0, double b,
                         double c) {
    const Dual<N> x = dsqrt(rs);
    const Dual<N> xx = x * x + b * x + c;
    const double xx0 = x0 * x0 + b * x0 + c;
    const double q = sqrt(4.0 * c - b * b);
    const Dual<N> atn = datan(q / (2.0 * x + b));
    return a * (dlog(x * x / xx) + (2.0 * b / q) * atn -
                (b * x0 / xx0) * (dlog(dsq(x - x0) / xx) + (2.0 * (b + 2.0 * x0) / q) * atn));
}

template <int N>
__device__ Dual<N> lda_c_vwn_e(const Dual<N>& nu, const Dual<N>& nd) {
    Dual<N> n, zeta, rs;
    zeta_rs(nu, nd, &n, &zeta, &rs);
    const Dual<N> ec0 = vwn_f(rs, 0.0310907, -0.10498, 3.72744, 12.9352);
    const Dual<N> ec1 = vwn_f(rs, 0.01554535, -0.325, 7.06042, 18.0578);
    const Dual<N> alc = vwn_f(rs, -1.0 / (6.0 * kPi * kPi), -0.0047584, 1.13107, 13.0045);
    const Dual<N> fz = zeta_f(zeta);
    const double fpp0 = 8.0 / (9.0 * (pow(2.0, 4.0 / 3.0) - 2.0));
    const Dual<N> z2 = zeta * zeta;
    const Dual<N> z4 = z2 * z2;
    const Dual<N> eps = ec0 + alc * fz / fpp0 * (1.0 - z4) + (ec1 - ec0) * fz * z4;
    return n * eps;
}

template <int N>
__device__ Dual<N> pbe_x_half(const Dual<N>& n2, const Dual<N>& sigma4, double mu) {
    const Dual<N> kf = dpow((3.0 * kPi * kPi) * n2, 1.0 / 3.0);
    const Dual<N> ex_lda = (-(3.0 / (4.0 * kPi))) * kf * n2;
    const Dual<N> s2 = sigma4 / dfloor(4.0 * dsq(kf) * dsq(n2), kTiny);
    const Dual<N> fx = (1.0 + kPbeKappa) - kPbeKappa / (1.0 + mu * s2 / kPbeKappa);
    return ex_lda * fx;
}

template <int N>
__device__ Dual<N> pbe_x_e(const Dual<N>& nu, const Dual<N>& nd, const Dual<N>& suu,
                           const Dual<N>& sdd, double mu) {
    return 0.5 * (pbe_x_half(2.0 * nu, 4.0 * suu, mu) + pbe_x_half(2.0 * nd, 4.0 * sdd, mu));
}

template <int N>
__device__ Dual<N> pbe_c_e(const Dual<N>& nu, const Dual<N>& nd, const Dual<N>& suu,
                           const Dual<N>& sud, const Dual<N>& sdd, double beta) {
    const double gamma = (1.0 - log(2.0)) / (kPi * kPi);
    const Dual<N> n = nu + nd;
    const Dual<N> zeta = dclip((nu - nd) / n, -1.0, 1.0);
    const Dual<N> sigma = suu + 2.0 * sud + sdd;
    const Dual<N> eps_lda = lda_c_pw_e(nu, nd, true) / n;
    const Dual<N> phi = 0.5 * (dpow(1.0 + zeta, 2.0 / 3.0) + dpow(1.0 - zeta, 2.0 / 3.0));
    const Dual<N> phi3 = phi * phi * phi;
    const Dual<N> kf = dpow((3.0 * kPi * kPi) * n, 1.0 / 3.0);
    const Dual<N> ks = dsqrt(4.0 * kf / kPi);
    const Dual<N> t2 = sigma / dfloor(dsq(2.0 * phi * ks * n), kTiny);
    const Dual<N> a_den = dexp(-eps_lda / (gamma * phi3)) - 1.0;
    const Dual<N> aa = (beta / gamma) / dfloor(a_den, kTiny);
    const Dual<N> num = 1.0 + aa * t2;
    const Dual<N> h = gamma * phi3 *
                      dlog1p((beta / gamma) * t2 * num / (1.0 + aa * t2 + dsq(aa) * dsq(t2)));
    return n * (eps_lda + h);
}

// ---- SCAN meta-GGA (xc.py:205-284) ----

// the alpha interpolation: only the selected branch is evaluated, so its
// value and derivative are the where's; the other branch (exp of a huge
// negative number, 0 with a finite slope in the JAX code) contributes
// nothing, as under jax.grad
template <int N>
__device__ Dual<N> scan_interp(const Dual<N>& alpha, double c1, double c2,
                               double d) {
    const Dual<N> am1 = alpha - 1.0;
    if (alpha.v < 1.0) return dexp((-c1) * alpha / dmaximum(-am1, 1e-12));
    return (-d) * dexp((-c2) / dmaximum(am1, 1e-12));
}

// exchange of one fully polarized channel (2 n_s, 4 sigma_ss, 2 tau_s)
template <int N>
__device__ Dual<N> scan_x_half(Dual<N> n2, const Dual<N>& sigma4,
                               const Dual<N>& tau2) {
    const double b2 = sqrt(5913.0 / 405000.0);
    const double b1 = (511.0 / 13500.0) / (2.0 * b2);
    const double b4 = kScanMu * kScanMu / kScanK1 - 1606.0 / 18225.0 - b1 * b1;
    const double pi2 = kPi * kPi;
    n2 = dmaximum(n2, kTiny);
    const Dual<N> kf = dpow((3.0 * pi2) * n2, 1.0 / 3.0);
    const Dual<N> ex_lda = (-(3.0 / (4.0 * kPi))) * kf * n2;
    const Dual<N> s2 = sigma4 / dmaximum(4.0 * dsq(kf) * dsq(n2), kTiny);
    const Dual<N> s = dsqrt(dmaximum(s2, kTiny));
    const Dual<N> tau_w = sigma4 / (8.0 * n2);
    const Dual<N> tau_u = (0.3 * pow(3.0 * pi2, 2.0 / 3.0)) * dpow(n2, 5.0 / 3.0);
    const Dual<N> alpha = dmaximum(tau2 - tau_w, 0.0) / dmaximum(tau_u, kTiny);
    const Dual<N> oma = 1.0 - alpha;
    const Dual<N> x =
        kScanMu * s2 * (1.0 + (b4 * s2 / kScanMu) * dexp((-fabs(b4)) * s2 / kScanMu)) +
        dsq(b1 * s2 + b2 * oma * dexp((-kScanB3) * dsq(oma)));
    const Dual<N> h1x = (1.0 + kScanK1) - kScanK1 / (1.0 + x / kScanK1);
    const Dual<N> fx = scan_interp(alpha, kScanC1x, kScanC2x, kScanDx);
    const Dual<N> gx = 1.0 - dexp((-kScanA1) / dsqrt(s));
    return ex_lda * ((h1x + fx * (kScanH0x - h1x)) * gx);
}

// correlation on (n_up, n_dn, sigma = suu + 2 sud + sdd, tau = tu + td):
// the caller forms sigma and tau and chains their partials back
template <int N>
__device__ Dual<N> scan_c_e(const Dual<N>& nu, const Dual<N>& nd,
                            const Dual<N>& sigma, const Dual<N>& tau) {
    const double pi2 = kPi * kPi;
    const Dual<N> n = dmaximum(nu + nd, kTiny);
    const Dual<N> zeta = dclip((nu - nd) / n, -0.999999, 0.999999);
    const Dual<N> rs = dpow(3.0 / ((4.0 * kPi) * n), 1.0 / 3.0);
    const Dual<N> kf = dpow((3.0 * pi2) * n, 1.0 / 3.0);
    const Dual<N> s2 = sigma / dmaximum(4.0 * dsq(kf) * dsq(n), kTiny);
    const Dual<N> opz = 1.0 + zeta;
    const Dual<N> omz = 1.0 - zeta;
    const Dual<N> ds = 0.5 * (dpow(opz, 5.0 / 3.0) + dpow(omz, 5.0 / 3.0));
    const Dual<N> tau_w = sigma / (8.0 * n);
    const Dual<N> tau_u =
        (0.3 * pow(3.0 * pi2, 2.0 / 3.0)) * dpow(n, 5.0 / 3.0) * ds;
    const Dual<N> alpha = dmaximum(tau - tau_w, 0.0) / dmaximum(tau_u, kTiny);
    const Dual<N> phi = 0.5 * (dpow(opz, 2.0 / 3.0) + dpow(omz, 2.0 / 3.0));
    const Dual<N> phi2 = dsq(phi);
    const Dual<N> phi3 = phi * phi2;

    // eps_c^1: PW92 + H1 (PBE-like with an rs-dependent beta)
    const Dual<N> eps_lsda = lda_c_pw_e(nu, nd, true) / n;
    const Dual<N> beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs);
    const Dual<N> t2 = pow(3.0 * pi2 / 16.0, 2.0 / 3.0) * s2 / dmaximum(phi2 * rs, kTiny);
    const Dual<N> w1 = dexpm1(-eps_lsda / (kScanGamma * phi3));
    const Dual<N> y = beta_rs / (kScanGamma * dmaximum(w1, kTiny)) * t2;
    const Dual<N> gy = dpow(1.0 + 4.0 * y, -0.25);
    const Dual<N> h1 = kScanGamma * phi3 * dlog1p(w1 * (1.0 - gy));
    const Dual<N> eps1 = eps_lsda + h1;

    // eps_c^0: the low-density limit + H0
    const Dual<N> eps_lda0 = (-kScanB1c) / (1.0 + kScanB2c * dsqrt(rs) + kScanB3c * rs);
    const Dual<N> w0 = dexpm1(-eps_lda0 / kScanB1c);
    const Dual<N> ginf = dpow(1.0 + (4.0 * kScanChi) * s2, -0.25);
    const Dual<N> h0 = kScanB1c * dlog1p(w0 * (1.0 - ginf));
    const Dual<N> dxz = 0.5 * (dpow(opz, 4.0 / 3.0) + dpow(omz, 4.0 / 3.0));
    const Dual<N> z2 = zeta * zeta;
    const Dual<N> z4 = z2 * z2;
    const Dual<N> z12 = z4 * (z4 * z4);
    const Dual<N> gc = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - z12);
    const Dual<N> eps0 = (eps_lda0 + h0) * gc;

    const Dual<N> fc = scan_interp(alpha, kScanC1c, kScanC2c, kScanDc);
    return n * (eps1 + fc * (eps0 - eps1));
}

// the masked sum of the functionals' energies after the _TINY floor
// (xc.py:328-339), in FUNC_BITS order
template <int N>
__device__ Dual<N> energy(int mask, Dual<N> nu, Dual<N> nd, const Dual<N>& suu,
                          const Dual<N>& sud, const Dual<N>& sdd) {
    nu = dfloor(nu, kTiny);
    nd = dfloor(nd, kTiny);
    Dual<N> e = constant<N>(0.0);
    if (mask & kLdaX) e = e + lda_x_e(nu, nd);
    if (mask & kLdaCPz) e = e + lda_c_pz_e(nu, nd);
    if (mask & kLdaCPw) e = e + lda_c_pw_e(nu, nd, false);
    if (mask & kLdaCVwn) e = e + lda_c_vwn_e(nu, nd);
    if (mask & kGgaXPbe) e = e + pbe_x_e(nu, nd, suu, sdd, kPbeMu);
    if (mask & kGgaCPbe) e = e + pbe_c_e(nu, nd, suu, sud, sdd, kPbeBeta);
    if (mask & kGgaXPbeSol) e = e + pbe_x_e(nu, nd, suu, sdd, kPbeSolMu);
    if (mask & kGgaCPbeSol) e = e + pbe_c_e(nu, nd, suu, sud, sdd, kPbeSolBeta);
    return e;
}

}  // namespace xc
