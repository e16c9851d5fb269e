// K7g: pointwise GGA exchange-correlation with the flux products of the
// divergence term, for any sum of the LDA and PBE-family functionals.
//
// Replaces the XLA fusions of sirius_tpu/dft/xc.py::XCFunctional._eval
// (:341-379) with the GGA energies (:141-182), and of the products of
// sirius_tpu/dft/potential.py that feed the divergence: polarized
// 2 vsigma_uu grad n_up + vsigma_ud grad n_dn and
// 2 vsigma_dd grad n_dn + vsigma_ud grad n_up (:132-137, device form
// :316-333), unpolarized 2 vsigma grad n (:155, :336-339).
//
// Per fine-box point the kernel forms sigma_uu, sigma_ud, sigma_dd from
// the gradients (as potential.py:116-118 sums them, component 0 first),
// applies the dead-channel sanitizing of xc.py:350-356 (a channel below
// _DENS_TH is evaluated at the threshold with its sigma, and the cross
// sigma, set to 0), evaluates the energy sum of xc_dual.cuh on dual numbers
// -- Dual<5> over (n_up, n_dn, sigma_uu, sigma_ud, sigma_dd) polarized,
// Dual<2> over (rho, sigma) unpolarized, where n_up = n_dn = rho/2 and every
// sigma is sigma/4 (xc.py:399-415) -- masks a dead channel's v and vsigma
// to 0 (:360-366), and writes e, v and the flux fields. sigma and vsigma
// never leave registers.
//
// LDA functionals of the same list (PBE X + PW C is legal) are summed in
// the same launch, on the same duals.
//
// Bound on the H100: bytes, by chip_smoke.py's counting rule. Bytes a
// point: polarized 64 in (n_up, n_dn, 6 gradient components) and 72 out
// (e, v_up, v_dn, 6 flux components); unpolarized 32 in and 40 out. The
// rule counts PBE exchange plus correlation on Dual<5> as ~1,050 fp64
// operations a point (175 operations of the energy, each elementary
// function one, times 1 + 5 partials), under the card's ~10 fp64
// operations a byte. pow, exp, log1p and atan are tens of instructions
// each in fp64, so the kernel itself is likely to run at the pace of its
// arithmetic, well above that bound.
//
// Design: one thread per point, grid-stride, no shared state.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "xc_dual.cuh"

namespace {

using xc::kDensTh;

__global__ void gga_xc_polarized(int mask, const double* __restrict__ nu_in,
                                 const double* __restrict__ nd_in,
                                 const double* __restrict__ gu,
                                 const double* __restrict__ gd,
                                 double* __restrict__ e_out,
                                 double* __restrict__ vu_out,
                                 double* __restrict__ vd_out,
                                 double* __restrict__ fu_out,
                                 double* __restrict__ fd_out, long long n) {
    using D = xc::Dual<5>;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        double a[3], b[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            a[c] = gu[c * n + i];
            b[c] = gd[c * n + i];
        }
        double suu = 0.0, sud = 0.0, sdd = 0.0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            suu = __dadd_rn(suu, __dmul_rn(a[c], a[c]));
            sdd = __dadd_rn(sdd, __dmul_rn(b[c], b[c]));
            sud = __dadd_rn(sud, __dmul_rn(a[c], b[c]));
        }
        const double nu = nu_in[i];
        const double nd = nd_in[i];
        const bool up0 = nu < kDensTh;
        const bool dn0 = nd < kDensTh;
        const D e = xc::energy<5>(
            mask, xc::seed<5>(up0 ? kDensTh : nu, 0),
            xc::seed<5>(dn0 ? kDensTh : nd, 1), xc::seed<5>(up0 ? 0.0 : suu, 2),
            xc::seed<5>((up0 || dn0) ? 0.0 : sud, 3),
            xc::seed<5>(dn0 ? 0.0 : sdd, 4));
        const double vsuu = up0 ? 0.0 : e.d[2];
        const double vsud = (up0 || dn0) ? 0.0 : e.d[3];
        const double vsdd = dn0 ? 0.0 : e.d[4];
        e_out[i] = e.v;
        vu_out[i] = up0 ? 0.0 : e.d[0];
        vd_out[i] = dn0 ? 0.0 : e.d[1];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            fu_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsuu, a[c]), __dmul_rn(vsud, b[c]));
            fd_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsdd, b[c]), __dmul_rn(vsud, a[c]));
        }
    }
}

__global__ void gga_xc_unpolarized(int mask, const double* __restrict__ rho_in,
                                   const double* __restrict__ g,
                                   double* __restrict__ e_out,
                                   double* __restrict__ v_out,
                                   double* __restrict__ f_out, long long n) {
    using D = xc::Dual<2>;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        double a[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) a[c] = g[c * n + i];
        double sigma = 0.0;
#pragma unroll
        for (int c = 0; c < 3; ++c) sigma = __dadd_rn(sigma, __dmul_rn(a[c], a[c]));
        const double half = 0.5 * rho_in[i];
        const bool dead = half < kDensTh;
        // d/drho of e(rho/2, rho/2, sigma/4, sigma/4, sigma/4) is
        // (v_up + v_dn)/2 and d/dsigma is (vsuu + vsud + vsdd)/4
        const D nh = xc::seed<2>(dead ? kDensTh : half, 0, 0.5);
        const D s4 = dead ? xc::constant<2>(0.0) : xc::seed<2>(0.25 * sigma, 1, 0.25);
        const D e = xc::energy<2>(mask, nh, nh, s4, s4, s4);
        const double vs = dead ? 0.0 : e.d[1];
        e_out[i] = e.v;
        v_out[i] = dead ? 0.0 : e.d[0];
#pragma unroll
        for (int c = 0; c < 3; ++c) f_out[c * n + i] = __dmul_rn(2.0 * vs, a[c]);
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

}  // namespace

// Polarized (unpolarized == 0): nu, nd [n], gu, gd [3, n] -> e, vu, vd [n],
// fu, fd [3, n]. Unpolarized: nu holds rho, gu its gradient [3, n]; nd, gd,
// vd and fd are unused, vu receives v and fu the flux 2 vsigma grad rho.
// Any mask bit outside the functionals of xc_dual.cuh, or an empty mask,
// returns cudaErrorInvalidValue without a launch.
extern "C" int gga_xc(const double* nu, const double* nd, const double* gu,
                      const double* gd, double* e, double* vu, double* vd,
                      double* fu, double* fd, long long n, int unpolarized,
                      int mask, void* stream) {
    if (mask <= 0 || mask > 255) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 128;
    if (n > 0) {
        if (unpolarized)
            gga_xc_unpolarized<<<grid_for(n, threads), threads, 0, s>>>(
                mask, nu, gu, e, vu, fu, n);
        else
            gga_xc_polarized<<<grid_for(n, threads), threads, 0, s>>>(
                mask, nu, nd, gu, gd, e, vu, vd, fu, fd, n);
    }
    return (int)cudaGetLastError();
}
