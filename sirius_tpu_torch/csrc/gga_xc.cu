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
// sigma, set to 0), evaluates the energy and its partials on dual numbers,
// masks a dead channel's v and vsigma to 0 (:360-366), and writes e, v and
// the flux fields. sigma and vsigma never leave registers.
//
// Three instantiations (kSet):
// - kPbe, kPbeSol: PBE or PBEsol exchange plus correlation, the sets the
//   port's decks run, on xc_sets.cuh. Polarized, each exchange half runs on
//   Dual<2> over (n_s, sigma_ss) (xc_dual.cuh's pbe_x_half, kF from pow:
//   see point_polarized) and correlation on Dual<3> over (n_up, n_dn,
//   sigma = sigma_uu + 2 sigma_ud + sigma_dd), chained back with the
//   weights (1, 2, 1); unpolarized, one Dual<2> over (rho, sigma) at
//   zeta = 0, one exchange half (0.5 (x + x) = x) and n^(1/3) shared.
// - kMask: any other sum of the LDA and PBE-family names (PBE X + PW C is
//   legal), the runtime mask over xc_dual.cuh's energies on Dual<5> over
//   (n_up, n_dn, sigma_uu, sigma_ud, sigma_dd) polarized, Dual<2> over
//   (rho, sigma) unpolarized, where n_up = n_dn = rho/2 and every sigma is
//   sigma/4 (xc.py:399-415).
//
// Bound on the H100: by chip_smoke.py's counting rule, bytes. Bytes a
// point: polarized 64 in (n_up, n_dn, 6 gradient components) and 72 out
// (e, v_up, v_dn, 6 flux components); unpolarized 32 in and 40 out. The
// kernel itself runs at the pace of its fp64 instructions: on the mask
// form's Dual<5> each dpow is two fp64 pow calls, and PBE polarized takes
// sixteen. The compiled sets take three cube roots and four pow calls
// polarized and one cube root unpolarized in their place, carry two or
// three partials in place of five, and fold the set's constants.
//
// Design: one thread per point, grid-stride, no shared state.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "xc_sets.cuh"

namespace {

using xc::kDensTh;

// instantiations; kernels/gga_xc.py::COMPILED_SETS passes the same numbers
enum : int { kMask = 0, kPbe = 1, kPbeSol = 2 };

template <int kSet>
struct SetOf;
template <>
struct SetOf<kPbe> {
    using T = xc::PbeSet;
    static constexpr int mask = xc::kGgaXPbe | xc::kGgaCPbe;
};
template <>
struct SetOf<kPbeSol> {
    using T = xc::PbeSolSet;
    static constexpr int mask = xc::kGgaXPbeSol | xc::kGgaCPbeSol;
};

// e and its partials along (n_up, n_dn, sigma_uu, sigma_ud, sigma_dd) at
// one sanitized point
template <int kSet>
__device__ __forceinline__ void point_polarized(int mask, double nu, double nd,
                                                double suu, double sud,
                                                double sdd, double* e,
                                                double* p) {
    if constexpr (kSet == kMask) {
        const xc::Dual<5> r = xc::energy<5>(
            mask, xc::seed<5>(nu, 0), xc::seed<5>(nd, 1), xc::seed<5>(suu, 2),
            xc::seed<5>(sud, 3), xc::seed<5>(sdd, 4));
        *e = r.v;
#pragma unroll
        for (int k = 0; k < 5; ++k) p[k] = r.d[k];
    } else {
        using S = typename SetOf<kSet>::T;
        using D2 = xc::Dual<2>;
        using D3 = xc::Dual<3>;
        // exchange, 0.5 (X(2 n_up, 4 sigma_uu) + X(2 n_dn, 4 sigma_dd)), each
        // half the mask form's pbe_x_half (its kF from pow). At a nearly
        // unpolarized point v_up - v_dn, the non-collinear path's B_xc, is
        // the difference of the two halves' rounding; with a cube root's
        // slope that noise was larger and moved a non-magnetic deck's
        // moment off its gate (PERF.md §6)
        const D2 xu = xc::pbe_x_half(2.0 * xc::seed<2>(nu, 0),
                                     4.0 * xc::seed<2>(suu, 1), S::kMu);
        const D2 xd = xc::pbe_x_half(2.0 * xc::seed<2>(nd, 0),
                                     4.0 * xc::seed<2>(sdd, 1), S::kMu);
        // correlation on (n_up, n_dn, sigma_uu + 2 sigma_ud + sigma_dd)
        const D3 u = xc::seed<3>(nu, 0);
        const D3 d = xc::seed<3>(nd, 1);
        const D3 n = u + d;
        const D3 c = xc::pbe_c_k<false>(u, d, xc::seed<3>(suu + 2.0 * sud + sdd, 2),
                                        n, xc::dcbrt(n), S::kBeta);
        *e = 0.5 * (xu.v + xd.v) + c.v;
        p[0] = 0.5 * xu.d[0] + c.d[0];
        p[1] = 0.5 * xd.d[0] + c.d[1];
        p[2] = 0.5 * xu.d[1] + c.d[2];
        p[3] = 2.0 * c.d[2];
        p[4] = 0.5 * xd.d[1] + c.d[2];
    }
}

// the energy at n_up = n_dn = rho/2, every sigma sigma/4, on Dual<2> over
// (rho, sigma): its partials are (v_up + v_dn)/2 and
// (vsigma_uu + vsigma_ud + vsigma_dd)/4
template <int kSet>
__device__ __forceinline__ xc::Dual<2> point_unpolarized(int mask, double half,
                                                         double sigma,
                                                         bool dead) {
    using D = xc::Dual<2>;
    const D nh = xc::seed<2>(dead ? kDensTh : half, 0, 0.5);
    const D s4 = dead ? xc::constant<2>(0.0) : xc::seed<2>(0.25 * sigma, 1, 0.25);
    if constexpr (kSet == kMask) {
        return xc::energy<2>(mask, nh, nh, s4, s4, s4);
    } else {
        using S = typename SetOf<kSet>::T;
        // n = 2 n_h is exchange's 2 n_s too: one n^(1/3), one kF
        const D n = nh + nh;
        const D cn = xc::dcbrt(n);
        const D x = xc::pbe_x_half_k(n, xc::kKfK * cn, 4.0 * s4, S::kMu);
        return x + xc::pbe_c_k<true>(nh, nh, s4 + 2.0 * s4 + s4, n, cn, S::kBeta);
    }
}

template <int kSet>
__global__ void gga_xc_polarized(int mask, const double* __restrict__ nu_in,
                                 const double* __restrict__ nd_in,
                                 const double* __restrict__ gu,
                                 const double* __restrict__ gd,
                                 double* __restrict__ e_out,
                                 double* __restrict__ vu_out,
                                 double* __restrict__ vd_out,
                                 double* __restrict__ fu_out,
                                 double* __restrict__ fd_out, long long n) {
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
        double e, p[5];
        point_polarized<kSet>(mask, up0 ? kDensTh : nu, dn0 ? kDensTh : nd,
                              up0 ? 0.0 : suu, (up0 || dn0) ? 0.0 : sud,
                              dn0 ? 0.0 : sdd, &e, p);
        const double vsuu = up0 ? 0.0 : p[2];
        const double vsud = (up0 || dn0) ? 0.0 : p[3];
        const double vsdd = dn0 ? 0.0 : p[4];
        e_out[i] = e;
        vu_out[i] = up0 ? 0.0 : p[0];
        vd_out[i] = dn0 ? 0.0 : p[1];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            fu_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsuu, a[c]), __dmul_rn(vsud, b[c]));
            fd_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsdd, b[c]), __dmul_rn(vsud, a[c]));
        }
    }
}

template <int kSet>
__global__ void gga_xc_unpolarized(int mask, const double* __restrict__ rho_in,
                                   const double* __restrict__ g,
                                   double* __restrict__ e_out,
                                   double* __restrict__ v_out,
                                   double* __restrict__ f_out, long long n) {
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
        const xc::Dual<2> e = point_unpolarized<kSet>(mask, half, sigma, dead);
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

template <int kSet>
void launch(const double* nu, const double* nd, const double* gu,
            const double* gd, double* e, double* vu, double* vd, double* fu,
            double* fd, long long n, int unpolarized, int mask,
            cudaStream_t s) {
    const int threads = 128;
    if (unpolarized)
        gga_xc_unpolarized<kSet><<<grid_for(n, threads), threads, 0, s>>>(
            mask, nu, gu, e, vu, fu, n);
    else
        gga_xc_polarized<kSet><<<grid_for(n, threads), threads, 0, s>>>(
            mask, nu, nd, gu, gd, e, vu, vd, fu, fd, n);
}

}  // namespace

// Polarized (unpolarized == 0): nu, nd [n], gu, gd [3, n] -> e, vu, vd [n],
// fu, fd [3, n]. Unpolarized: nu holds rho, gu its gradient [3, n]; nd, gd,
// vd and fd are unused, vu receives v and fu the flux 2 vsigma grad rho.
// set picks the instantiation (kMask, kPbe, kPbeSol); a compiled set's mask
// must be that set's. Any mask bit outside the functionals of xc_dual.cuh,
// an empty mask, an unknown set or a set whose mask differs returns
// cudaErrorInvalidValue without a launch.
extern "C" int gga_xc(const double* nu, const double* nd, const double* gu,
                      const double* gd, double* e, double* vu, double* vd,
                      double* fu, double* fd, long long n, int unpolarized,
                      int mask, int set, void* stream) {
    if (mask <= 0 || mask > 255) return (int)cudaErrorInvalidValue;
    if ((set == kPbe && mask != SetOf<kPbe>::mask) ||
        (set == kPbeSol && mask != SetOf<kPbeSol>::mask) ||
        set < kMask || set > kPbeSol)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        if (set == kPbe)
            launch<kPbe>(nu, nd, gu, gd, e, vu, vd, fu, fd, n, unpolarized, mask, s);
        else if (set == kPbeSol)
            launch<kPbeSol>(nu, nd, gu, gd, e, vu, vd, fu, fd, n, unpolarized, mask, s);
        else
            launch<kMask>(nu, nd, gu, gd, e, vu, vd, fu, fd, n, unpolarized, mask, s);
    }
    return (int)cudaGetLastError();
}
