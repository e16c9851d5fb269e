// K7: pointwise LDA exchange-correlation, XC_LDA_X + XC_LDA_C_PZ.
//
// Replaces the XLA fusion of sirius_tpu/dft/xc.py::XCFunctional._eval
// (:341-379) for the functional pair X + PZ (:33-66): the energy per volume
// e(n_up, n_dn) and its exact derivatives v_up, v_dn, which the JAX package
// takes from jax.grad. Here they are the closed-form derivatives of the same
// expressions, with the same libxc-style masking: a channel below
// _DENS_TH = 1e-13 is evaluated at the threshold and its potential is zero
// (xc.py:350-371), after the _TINY = 1e-25 floor (xc.py:28,329-330).
//
// Bound on the H100: bytes. Per fine-box point it reads 16 bytes and writes
// 24 (polarized) or reads 8 and writes 16 (unpolarized), against ~60 fp64
// flops including cbrt/pow/log/sqrt, well under the fp64 rate.
//
// Design: one thread per point, no shared state. The unpolarized form feeds
// n_up = n_dn = rho/2 and returns e and v = (v_up + v_dn)/2 in place of
// (v_up, v_dn), as xc.py:403-410 does, so no half-density arrays exist.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.141592653589793;
constexpr double kTiny = 1e-25;
constexpr double kDensTh = 1e-13;

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

__global__ void lda_xc_points(const double* __restrict__ nu_in,
                              const double* __restrict__ nd_in,
                              double* __restrict__ e_out,
                              double* __restrict__ vu_out,
                              double* __restrict__ vd_out, long long n,
                              int unpolarized) {
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
        x_pz(up0 ? kDensTh : nu, dn0 ? kDensTh : nd, &e, &vu, &vd);
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

}  // namespace

// Polarized: nu, nd -> e, vu, vd. Unpolarized (unpolarized != 0): nu holds
// rho, nd and vd are unused, vu receives v = (v_up + v_dn) / 2.
extern "C" int lda_xc(const double* nu, const double* nd, double* e, double* vu,
                      double* vd, long long n, int unpolarized, void* stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks > 0)
        lda_xc_points<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            nu, nd, e, vu, vd, n, unpolarized);
    return (int)cudaGetLastError();
}
