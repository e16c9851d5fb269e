// K7s: pointwise SCAN meta-GGA exchange-correlation with the flux products
// of the divergence term and v_tau, for SCAN exchange and / or correlation
// plus any LDA and PBE-family functionals of the same list.
//
// Replaces the XLA fusions of sirius_tpu/dft/xc.py::XCFunctional._eval
// (:341-379) with the SCAN energies (:205-297), and of the products of
// sirius_tpu/dft/potential.py that feed the divergence (polarized :116-137,
// unpolarized :146-155, the mGGA inputs at :116-125 and :151).
//
// Per fine-box point the kernel forms sigma_uu, sigma_ud, sigma_dd from the
// gradients (component 0 first, as potential.py:113-115 sums them), applies
// the dead-channel sanitizing of xc.py:350-356 (a channel below _DENS_TH is
// evaluated at the threshold with its sigma, and the cross sigma, set to 0;
// tau enters as given), evaluates the energy on dual numbers, masks a dead
// channel's v, vsigma and v_tau to 0 (:367-375), and writes e, v, the flux
// fields 2 vsigma_ss grad n_s + vsigma_ud grad n_s' and v_tau. sigma and
// vsigma never leave registers.
//
// Dual numbers sized to the structure of SCAN, so no single Dual<7> over
// all seven inputs is carried: exchange is spin-scaled (xc.py:238-242), so
// each channel runs on Dual<3> over (n_s, sigma_ss, tau_s); correlation
// reads (n_up, n_dn, sigma, tau) with sigma = suu + 2 sud + sdd and
// tau = tu + td, so it runs on Dual<4> and its sigma and tau partials are
// chained back with the weights (1, 2, 1) and (1, 1). LDA and GGA
// functionals of the same list (["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"] is
// legal) run in the same launch on K7g's Dual<5> (a second instantiation,
// so a pure SCAN list does not carry its registers). Unpolarized, the JAX
// package's mapping _eval(rho/2, rho/2, sigma/4, sigma/4, sigma/4, tau/2,
// tau/2) (xc.py:399-415) runs on one Dual<3> over (rho, sigma, tau) whose
// seeds carry the slopes 1/2, 1/4, 1/2: its partials are (v_up + v_dn)/2,
// (vsigma_uu + vsigma_ud + vsigma_dd)/4 and (vtau_up + vtau_dn)/2.
//
// Three instantiations (kKind): kScanSet, SCAN exchange plus correlation
// alone, the set the port's decks run, on xc_sets.cuh (cube roots and
// square roots in place of pow, n^(1/3) and (1 +- zeta)^(1/3) shared, and
// unpolarized one exchange half, 0.5 (x + x) = x, at zeta = 0); kMask, a
// SCAN name alone, and kMaskLdaGga, SCAN names with LDA / PBE-family ones,
// on xc_dual.cuh's runtime mask.
//
// Bound on the H100: polarized, the bytes (80 in and 88 out a point), the
// operations by chip_smoke.py's counting rule (each SCAN term times 1 +
// the partials of the dual it runs on) within 3 % of them; unpolarized,
// the operations, above the bytes (40 in, 48 out). The kernel runs at the
// pace of its fp64 instructions: xc_dual.cuh's dpow is two fp64 pow calls,
// and SCAN polarized takes seventeen dpow on the mask form; the compiled
// set takes five cube roots (seven where |zeta| > 0.999999) and two rsqrt.
//
// Design: one thread per point, grid-stride, no shared state.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "xc_sets.cuh"

namespace {

using xc::kDensTh;

// instantiations; kernels/mgga_xc.py::COMPILED_SETS passes kScanSet's number
enum : int { kMask = 0, kScanSet = 1, kMaskLdaGga = 2 };
constexpr int kScanSetMask = xc::kMggaXScan | xc::kMggaCScan;
// blocks of 128 an SM the compiled set is held to: its inlined cube roots
// took 218 registers polarized (124 unpolarized), 4 (8) of the SM's 64
// warps; capped at 128 (80) registers, with 232 (256) bytes of spills, it
// ran 1.08 -> 0.79 ms (0.36 -> 0.32) on the 54-atom field (H100,
// chip_smoke.py records, PERF.md §6)
constexpr int kScanPolBlocks = 4;
constexpr int kScanUnpolBlocks = 6;

// e and its partials along (n_up, n_dn, sigma_uu, sigma_ud, sigma_dd,
// tau_up, tau_dn) at one sanitized point
template <int kKind>
__device__ __forceinline__ void point_polarized(int mask, double nu, double nd,
                                                double suu, double sud,
                                                double sdd, double tu,
                                                double td, double* e,
                                                double* p) {
    *e = 0.0;
#pragma unroll
    for (int k = 0; k < 7; ++k) p[k] = 0.0;
    if constexpr (kKind == kMaskLdaGga) {
        if (mask & xc::kLdaGgaBits) {
            const xc::Dual<5> g = xc::energy<5>(
                mask & xc::kLdaGgaBits, xc::seed<5>(nu, 0), xc::seed<5>(nd, 1),
                xc::seed<5>(suu, 2), xc::seed<5>(sud, 3), xc::seed<5>(sdd, 4));
            *e += g.v;
#pragma unroll
            for (int k = 0; k < 5; ++k) p[k] += g.d[k];
        }
    }
    if (kKind == kScanSet || (mask & xc::kMggaXScan)) {
        // 0.5 (X(2 nu, 4 suu, 2 tu) + X(2 nd, 4 sdd, 2 td))
        using D = xc::Dual<3>;
        D xu, xd;
        if constexpr (kKind == kScanSet) {
            xu = xc::scan_x_channel(xc::seed<3>(nu, 0), xc::seed<3>(suu, 1),
                                    xc::seed<3>(tu, 2));
            xd = xc::scan_x_channel(xc::seed<3>(nd, 0), xc::seed<3>(sdd, 1),
                                    xc::seed<3>(td, 2));
        } else {
            xu = xc::scan_x_half(2.0 * xc::seed<3>(nu, 0),
                                 4.0 * xc::seed<3>(suu, 1),
                                 2.0 * xc::seed<3>(tu, 2));
            xd = xc::scan_x_half(2.0 * xc::seed<3>(nd, 0),
                                 4.0 * xc::seed<3>(sdd, 1),
                                 2.0 * xc::seed<3>(td, 2));
        }
        *e += 0.5 * (xu.v + xd.v);
        p[0] += 0.5 * xu.d[0];
        p[2] += 0.5 * xu.d[1];
        p[5] += 0.5 * xu.d[2];
        p[1] += 0.5 * xd.d[0];
        p[4] += 0.5 * xd.d[1];
        p[6] += 0.5 * xd.d[2];
    }
    if (kKind == kScanSet || (mask & xc::kMggaCScan)) {
        using D = xc::Dual<4>;
        const D u = xc::seed<4>(nu, 0);
        const D d = xc::seed<4>(nd, 1);
        const D sigma = xc::seed<4>(suu + 2.0 * sud + sdd, 2);
        const D tau = xc::seed<4>(tu + td, 3);
        D c;
        if constexpr (kKind == kScanSet) {
            const D n = xc::dmaximum(u + d, xc::kTiny);
            const D cn = xc::dcbrt(n);
            const D kf = xc::kKfK * cn;
            c = xc::scan_c_k<false>(u, d, sigma, tau, n, cn, n * xc::dsq(cn),
                                    xc::dmaximum(4.0 * xc::dsq(kf) * xc::dsq(n),
                                                 xc::kTiny));
        } else {
            c = xc::scan_c_e(u, d, sigma, tau);
        }
        *e += c.v;
        p[0] += c.d[0];
        p[1] += c.d[1];
        p[2] += c.d[2];
        p[3] += 2.0 * c.d[2];
        p[4] += c.d[2];
        p[5] += c.d[3];
        p[6] += c.d[3];
    }
}

// the energy at n_up = n_dn = rho/2, every sigma sigma/4, tau_up = tau_dn =
// tau/2, on Dual<3> over (rho, sigma, tau): its partials are
// (v_up + v_dn)/2, (vsigma_uu + vsigma_ud + vsigma_dd)/4 and
// (vtau_up + vtau_dn)/2
template <int kKind>
__device__ __forceinline__ xc::Dual<3> point_unpolarized(int mask, double half,
                                                         double sigma,
                                                         double tau2,
                                                         bool dead) {
    using D = xc::Dual<3>;
    const D nh = xc::seed<3>(dead ? kDensTh : half, 0, 0.5);
    const D s4 = dead ? xc::constant<3>(0.0) : xc::seed<3>(0.25 * sigma, 1, 0.25);
    const D t2 = xc::seed<3>(tau2, 2, 0.5);
    if constexpr (kKind == kScanSet) {
        // n = max(2 n_h, _TINY) is exchange's max(2 n_s, _TINY) too: one
        // n^(1/3), n^(5/3) and max(4 kF^2 n^2, _TINY) for both
        const D n = xc::dmaximum(nh + nh, xc::kTiny);
        const D cn = xc::dcbrt(n);
        const D kf = xc::kKfK * cn;
        const D n53 = n * xc::dsq(cn);
        const D den = xc::dmaximum(4.0 * xc::dsq(kf) * xc::dsq(n), xc::kTiny);
        const D x = xc::scan_x_half_k(n, kf, n53, den, 4.0 * s4, 2.0 * t2);
        return x + xc::scan_c_k<true>(nh, nh, s4 + 2.0 * s4 + s4, t2 + t2, n,
                                      cn, n53, den);
    } else {
        D e = xc::constant<3>(0.0);
        if (kKind == kMaskLdaGga && (mask & xc::kLdaGgaBits))
            e = e + xc::energy<3>(mask & xc::kLdaGgaBits, nh, nh, s4, s4, s4);
        if (mask & xc::kMggaXScan) {
            const D x = xc::scan_x_half(2.0 * nh, 4.0 * s4, 2.0 * t2);
            e = e + 0.5 * (x + x);
        }
        if (mask & xc::kMggaCScan)
            e = e + xc::scan_c_e(nh, nh, s4 + 2.0 * s4 + s4, t2 + t2);
        return e;
    }
}

template <int kKind>
__global__ void __launch_bounds__(128, kKind == kScanSet ? kScanPolBlocks : 1)
mgga_xc_polarized(int mask, const double* __restrict__ nu_in,
                  const double* __restrict__ nd_in,
                  const double* __restrict__ gu,
                  const double* __restrict__ gd,
                  const double* __restrict__ tu_in,
                  const double* __restrict__ td_in,
                  double* __restrict__ e_out,
                  double* __restrict__ vu_out,
                  double* __restrict__ vd_out,
                  double* __restrict__ fu_out,
                  double* __restrict__ fd_out,
                  double* __restrict__ vtu_out,
                  double* __restrict__ vtd_out, long long n) {
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
        const bool up0 = nu_in[i] < kDensTh;
        const bool dn0 = nd_in[i] < kDensTh;
        const double nu = up0 ? kDensTh : nu_in[i];
        const double nd = dn0 ? kDensTh : nd_in[i];
        if (up0) suu = 0.0;
        if (dn0) sdd = 0.0;
        if (up0 || dn0) sud = 0.0;
        // tau enters as given
        double e, p[7];
        point_polarized<kKind>(mask, nu, nd, suu, sud, sdd, tu_in[i], td_in[i],
                               &e, p);
        const double vsuu = up0 ? 0.0 : p[2];
        const double vsud = (up0 || dn0) ? 0.0 : p[3];
        const double vsdd = dn0 ? 0.0 : p[4];
        e_out[i] = e;
        vu_out[i] = up0 ? 0.0 : p[0];
        vd_out[i] = dn0 ? 0.0 : p[1];
        vtu_out[i] = up0 ? 0.0 : p[5];
        vtd_out[i] = dn0 ? 0.0 : p[6];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            fu_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsuu, a[c]), __dmul_rn(vsud, b[c]));
            fd_out[c * n + i] =
                __dadd_rn(__dmul_rn(2.0 * vsdd, b[c]), __dmul_rn(vsud, a[c]));
        }
    }
}

template <int kKind>
__global__ void __launch_bounds__(128, kKind == kScanSet ? kScanUnpolBlocks : 1)
mgga_xc_unpolarized(int mask, const double* __restrict__ rho_in,
                    const double* __restrict__ g,
                    const double* __restrict__ tau_in,
                    double* __restrict__ e_out,
                    double* __restrict__ v_out,
                    double* __restrict__ f_out,
                    double* __restrict__ vt_out, long long n) {
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
        const xc::Dual<3> e =
            point_unpolarized<kKind>(mask, half, sigma, 0.5 * tau_in[i], dead);
        const double vs = dead ? 0.0 : e.d[1];
        e_out[i] = e.v;
        v_out[i] = dead ? 0.0 : e.d[0];
        vt_out[i] = dead ? 0.0 : e.d[2];
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

template <int kKind>
void launch(const double* nu, const double* nd, const double* gu,
            const double* gd, const double* tu, const double* td, double* e,
            double* vu, double* vd, double* fu, double* fd, double* vtu,
            double* vtd, long long n, int unpolarized, int mask,
            cudaStream_t s) {
    const int threads = 128;
    const int blocks = grid_for(n, threads);
    if (unpolarized)
        mgga_xc_unpolarized<kKind><<<blocks, threads, 0, s>>>(
            mask, nu, gu, tu, e, vu, fu, vtu, n);
    else
        mgga_xc_polarized<kKind><<<blocks, threads, 0, s>>>(
            mask, nu, nd, gu, gd, tu, td, e, vu, vd, fu, fd, vtu, vtd, n);
}

}  // namespace

// Polarized (unpolarized == 0): nu, nd, tu, td [n], gu, gd [3, n] -> e, vu,
// vd, vtu, vtd [n], fu, fd [3, n]. Unpolarized: nu holds rho, gu its
// gradient [3, n], tu the total tau; nd, gd, td, vd, fd and vtd are unused,
// vu receives v, fu the flux 2 vsigma grad rho and vtu v_tau. The mask
// must hold a SCAN bit; set 1 (kScanSet) runs the compiled SCAN X + C set
// and needs exactly its mask, set 0 the runtime mask. Any bit outside the
// functionals of xc_dual.cuh, an unknown set or a set whose mask differs
// returns cudaErrorInvalidValue without a launch.
extern "C" int mgga_xc(const double* nu, const double* nd, const double* gu,
                       const double* gd, const double* tu, const double* td,
                       double* e, double* vu, double* vd, double* fu,
                       double* fd, double* vtu, double* vtd, long long n,
                       int unpolarized, int mask, int set, void* stream) {
    if (mask <= 0 || mask > 1023 || !(mask & xc::kMggaBits))
        return (int)cudaErrorInvalidValue;
    if ((set != kMask && set != kScanSet) ||
        (set == kScanSet && mask != kScanSetMask))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        if (set == kScanSet)
            launch<kScanSet>(nu, nd, gu, gd, tu, td, e, vu, vd, fu, fd, vtu,
                             vtd, n, unpolarized, mask, s);
        else if (mask & xc::kLdaGgaBits)
            launch<kMaskLdaGga>(nu, nd, gu, gd, tu, td, e, vu, vd, fu, fd, vtu,
                                vtd, n, unpolarized, mask, s);
        else
            launch<kMask>(nu, nd, gu, gd, tu, td, e, vu, vd, fu, fd, vtu, vtd,
                          n, unpolarized, mask, s);
    }
    return (int)cudaGetLastError();
}
