"""The exchange-correlation energies of the port, as plain PyTorch.

A copy of the energy expressions of sirius_tpu/dft/xc.py (:23-297,
:328-379) for the LDA, GGA and SCAN meta-GGA functionals: each is an
energy per volume e(n_up, n_dn [, sigma_uu, sigma_ud, sigma_dd [, tau_up,
tau_dn]]) (libxc's n * eps), and every potential is an exact derivative of
that energy. Here the derivatives come from torch.autograd over the same
expressions, the counterpart of the JAX package's jax.grad; the CUDA
kernels K7 (csrc/lda_xc.cu), K7g (csrc/gga_xc.cu) and K7s
(csrc/mgga_xc.cu) are held against these plain versions.

Hartree atomic units; sigma = |grad n|^2 contractions, libxc convention;
tau the positive Kohn-Sham kinetic-energy density (1/2) sum occ |grad psi|^2
per spin.
"""

from __future__ import annotations

import math

import torch

TINY = 1e-25
# vacuum threshold for a spin channel (libxc dens_threshold analog)
DENS_TH = 1e-13

PBE_KAPPA = 0.804
PBE_MU = 0.2195149727645171
PBE_BETA = 0.06672455060314922
PBE_GAMMA = (1.0 - math.log(2.0)) / math.pi**2
# PBEsol (Perdew et al. 2008): restores the gradient expansion for exchange
PBESOL_MU = 10.0 / 81.0
PBESOL_BETA = 0.046


def _floor(x, lo):
    return torch.clamp(x, min=lo)


def _maximum(x, lo: float):
    """jnp.maximum(x, lo) with its derivative: at a tie the slope is split
    in half, as both jax.grad and torch.maximum do."""
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device))


def lda_x_e(nu, nd):
    """Slater exchange energy per volume, spin-scaled (xc.py:33-36)."""
    cx = (3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0)
    return -cx / 2.0 * ((2 * nu) ** (4.0 / 3.0) + (2 * nd) ** (4.0 / 3.0))


def _pz_eps(rs, pol: bool):
    if pol:
        gamma, b1, b2 = -0.0843, 1.3981, 0.2611
        a, b, c, d = 0.01555, -0.0269, 0.0007, -0.0048
    else:
        gamma, b1, b2 = -0.1423, 1.0529, 0.3334
        a, b, c, d = 0.0311, -0.048, 0.002, -0.0116
    lo = gamma / (1.0 + b1 * torch.sqrt(rs) + b2 * rs)
    hi = a * torch.log(rs) + b + c * rs * torch.log(rs) + d * rs
    return torch.where(rs >= 1.0, lo, hi)


def _zeta_f(zeta):
    return ((1 + zeta) ** (4.0 / 3.0) + (1 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 ** (4.0 / 3.0) - 2.0)


def _zeta_rs(nu, nd):
    n = nu + nd
    zeta = torch.clamp((nu - nd) / n, -1.0, 1.0)
    rs = (3.0 / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    return n, zeta, rs


def lda_c_pz_e(nu, nd):
    """Perdew-Zunger 81 correlation energy per volume (xc.py:55-62)."""
    n, zeta, rs = _zeta_rs(nu, nd)
    eu = _pz_eps(rs, False)
    ep = _pz_eps(rs, True)
    return n * (eu + _zeta_f(zeta) * (ep - eu))


def _pw92_g(rs, a, a1, b1, b2, b3, b4):
    s = torch.sqrt(rs)
    den = 2.0 * a * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs)
    return -2.0 * a * (1 + a1 * rs) * torch.log1p(1.0 / den)


def lda_c_pw_e(nu, nd, mod: bool = False):
    """Perdew-Wang 92 correlation, full spin interpolation (xc.py:73-97).
    mod=True takes the PW_MOD digits on the A coefficients, on which PBE
    correlation is defined; XC_LDA_C_PW takes the published PW92 digits."""
    n, zeta, rs = _zeta_rs(nu, nd)
    a0, a1, a2 = ((0.0310907, 0.01554535, 0.0168869) if mod
                  else (0.031091, 0.015545, 0.016887))
    ec0 = _pw92_g(rs, a0, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    ec1 = _pw92_g(rs, a1, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    # the spin-stiffness fit parametrizes -alpha_c: alpha_c enters the
    # interpolation with a positive sign
    mac = -_pw92_g(rs, a2, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    fz = _zeta_f(zeta)
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))
    z4 = zeta**4
    eps = ec0 + mac * fz / fpp0 * (1 - z4) + (ec1 - ec0) * fz * z4
    return n * eps


def _vwn_f(rs, a, x0, b, c):
    """VWN5 Pade fit of one correlation channel (xc.py:100-114)."""
    x = torch.sqrt(rs)

    def big_x(t):
        return t * t + b * t + c

    q = math.sqrt(4.0 * c - b * b)
    atn = torch.atan(q / (2.0 * x + b))
    return a * (
        torch.log(x * x / big_x(x))
        + 2.0 * b / q * atn
        - b * x0 / big_x(x0) * (
            torch.log((x - x0) ** 2 / big_x(x))
            + 2.0 * (b + 2.0 * x0) / q * atn))


def lda_c_vwn_e(nu, nd):
    """VWN5 correlation, full spin interpolation (xc.py:117-133)."""
    n, zeta, rs = _zeta_rs(nu, nd)
    ec0 = _vwn_f(rs, 0.0310907, -0.10498, 3.72744, 12.9352)
    ec1 = _vwn_f(rs, 0.01554535, -0.325, 7.06042, 18.0578)
    alc = _vwn_f(rs, -1.0 / (6.0 * math.pi**2), -0.0047584, 1.13107, 13.0045)
    fz = _zeta_f(zeta)
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))
    z4 = zeta**4
    eps = ec0 + alc * fz / fpp0 * (1 - z4) + (ec1 - ec0) * fz * z4
    return n * eps


def _pbe_x_half(n2, sigma4, mu: float):
    """PBE-family exchange per volume of a fully polarized channel
    (2 n_s, 4 sigma_ss), halved by the caller's spin scaling."""
    kf = (3.0 * math.pi**2 * n2) ** (1.0 / 3.0)
    ex_lda = -(3.0 / (4.0 * math.pi)) * kf * n2
    s2 = sigma4 / _floor(4.0 * kf**2 * n2**2, TINY)
    fx = 1.0 + PBE_KAPPA - PBE_KAPPA / (1.0 + mu * s2 / PBE_KAPPA)
    return ex_lda * fx


def pbe_x_e(nu, nd, suu, sud, sdd, mu: float = PBE_MU):
    """PBE exchange (xc.py:151-154)."""
    return 0.5 * (_pbe_x_half(2 * nu, 4 * suu, mu)
                  + _pbe_x_half(2 * nd, 4 * sdd, mu))


def pbe_c_e(nu, nd, suu, sud, sdd, beta: float = PBE_BETA):
    """PBE correlation on PW_MOD (xc.py:157-174)."""
    n = nu + nd
    zeta = torch.clamp((nu - nd) / n, -1.0, 1.0)
    sigma = suu + 2 * sud + sdd
    eps_lda = lda_c_pw_e(nu, nd, mod=True) / n
    phi = 0.5 * ((1 + zeta) ** (2.0 / 3.0) + (1 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * math.pi**2 * n) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / math.pi)
    t2 = sigma / _floor((2.0 * phi * ks * n) ** 2, TINY)
    a_den = torch.exp(-eps_lda / (PBE_GAMMA * phi**3)) - 1.0
    aa = beta / PBE_GAMMA / _floor(a_den, TINY)
    num = 1.0 + aa * t2
    h = PBE_GAMMA * phi**3 * torch.log1p(
        beta / PBE_GAMMA * t2 * num / (1.0 + aa * t2 + aa**2 * t2**2))
    return n * (eps_lda + h)


def pbesol_x_e(nu, nd, suu, sud, sdd):
    return pbe_x_e(nu, nd, suu, sud, sdd, mu=PBESOL_MU)


def pbesol_c_e(nu, nd, suu, sud, sdd):
    return pbe_c_e(nu, nd, suu, sud, sdd, beta=PBESOL_BETA)


# ---------------------------------------------------------------------------
# SCAN meta-GGA (Sun, Ruzsinszky, Perdew, PRL 115, 036402 (2015)), as the
# energy density only (xc.py:183-284); the potentials are its derivatives.

SCAN_K1 = 0.065
SCAN_MU = 10.0 / 81.0
SCAN_B2 = math.sqrt(5913.0 / 405000.0)
SCAN_B1 = (511.0 / 13500.0) / (2.0 * SCAN_B2)
SCAN_B3 = 0.5
SCAN_B4 = SCAN_MU**2 / SCAN_K1 - 1606.0 / 18225.0 - SCAN_B1**2
SCAN_H0X = 1.174
SCAN_A1 = 4.9479
SCAN_C1X, SCAN_C2X, SCAN_DX = 0.667, 0.8, 1.24
SCAN_C1C, SCAN_C2C, SCAN_DC = 0.64, 1.5, 0.7
SCAN_B1C, SCAN_B2C, SCAN_B3C = 0.0285764, 0.0889, 0.125541
SCAN_CHI = 0.12802585262625815
SCAN_GAMMA = 0.031091


def _scan_interp(alpha, c1, c2, d):
    """SCAN's alpha interpolation f(alpha) (xc.py:205-212): exp(-c1 a/(1-a))
    below alpha = 1, -d exp(c2/(1-a)) above, with the JAX package's clamps."""
    am1 = alpha - 1.0
    lo = torch.exp(-c1 * alpha / _maximum(-am1, 1e-12))
    hi = -d * torch.exp(-c2 / _maximum(am1, 1e-12))
    return torch.where(alpha < 1.0, lo, hi)


def scan_x_half(n2, sigma4, tau2):
    """SCAN exchange per volume of one fully polarized channel (2 n_s,
    4 sigma_ss, 2 tau_s), halved by the caller's spin scaling
    (xc.py:215-235)."""
    n2 = _maximum(n2, TINY)
    kf = (3.0 * math.pi**2 * n2) ** (1.0 / 3.0)
    ex_lda = -(3.0 / (4.0 * math.pi)) * kf * n2
    s2 = sigma4 / _maximum(4.0 * kf**2 * n2**2, TINY)
    s = torch.sqrt(_maximum(s2, TINY))
    tau_w = sigma4 / (8.0 * n2)
    tau_u = 0.3 * (3.0 * math.pi**2) ** (2.0 / 3.0) * n2 ** (5.0 / 3.0)
    alpha = _maximum(tau2 - tau_w, 0.0) / _maximum(tau_u, TINY)
    x = SCAN_MU * s2 * (
        1.0 + (SCAN_B4 * s2 / SCAN_MU)
        * torch.exp(-abs(SCAN_B4) * s2 / SCAN_MU)
    ) + (
        SCAN_B1 * s2
        + SCAN_B2 * (1.0 - alpha) * torch.exp(-SCAN_B3 * (1.0 - alpha) ** 2)
    ) ** 2
    h1x = 1.0 + SCAN_K1 - SCAN_K1 / (1.0 + x / SCAN_K1)
    fx = _scan_interp(alpha, SCAN_C1X, SCAN_C2X, SCAN_DX)
    gx = 1.0 - torch.exp(-SCAN_A1 / torch.sqrt(s))
    fx_tot = (h1x + fx * (SCAN_H0X - h1x)) * gx
    return ex_lda * fx_tot


def scan_x_e(nu, nd, suu, sud, sdd, tu, td):
    """SCAN exchange, spin-scaled (xc.py:238-242)."""
    return 0.5 * (scan_x_half(2 * nu, 4 * suu, 2 * tu)
                  + scan_x_half(2 * nd, 4 * sdd, 2 * td))


def scan_c_e(nu, nd, suu, sud, sdd, tu, td):
    """SCAN correlation (xc.py:245-284)."""
    n = _maximum(nu + nd, TINY)
    zeta = torch.clamp((nu - nd) / n, -0.999999, 0.999999)
    sigma = suu + 2.0 * sud + sdd
    tau = tu + td
    rs = (3.0 / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    kf = (3.0 * math.pi**2 * n) ** (1.0 / 3.0)
    s2 = sigma / _maximum(4.0 * kf**2 * n**2, TINY)
    ds = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    tau_w = sigma / (8.0 * n)
    tau_u = 0.3 * (3.0 * math.pi**2) ** (2.0 / 3.0) * n ** (5.0 / 3.0) * ds
    alpha = _maximum(tau - tau_w, 0.0) / _maximum(tau_u, TINY)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))

    # eps_c^1: PW92 + H1 (PBE-like with an rs-dependent beta)
    eps_lsda = lda_c_pw_e(nu, nd, mod=True) / n
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    t2 = ((3.0 * math.pi**2 / 16.0) ** (2.0 / 3.0) * s2
          / _maximum(phi**2 * rs, TINY))
    w1 = torch.expm1(-eps_lsda / (SCAN_GAMMA * phi**3))
    y = beta_rs / (SCAN_GAMMA * _maximum(w1, TINY)) * t2
    gy = (1.0 + 4.0 * y) ** (-0.25)
    h1 = SCAN_GAMMA * phi**3 * torch.log1p(w1 * (1.0 - gy))
    eps1 = eps_lsda + h1

    # eps_c^0: the low-density limit + H0
    eps_lda0 = -SCAN_B1C / (1.0 + SCAN_B2C * torch.sqrt(rs) + SCAN_B3C * rs)
    w0 = torch.expm1(-eps_lda0 / SCAN_B1C)
    ginf = (1.0 + 4.0 * SCAN_CHI * s2) ** (-0.25)
    h0 = SCAN_B1C * torch.log1p(w0 * (1.0 - ginf))
    dxz = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gc = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - zeta**12)
    eps0 = (eps_lda0 + h0) * gc

    fc = _scan_interp(alpha, SCAN_C1C, SCAN_C2C, SCAN_DC)
    return n * (eps1 + fc * (eps0 - eps1))


LDA_FUNCS = {
    "XC_LDA_X": lda_x_e,
    "XC_LDA_C_PZ": lda_c_pz_e,
    "XC_LDA_C_PW": lda_c_pw_e,
    "XC_LDA_C_VWN": lda_c_vwn_e,
}
GGA_FUNCS = {
    "XC_GGA_X_PBE": pbe_x_e,
    "XC_GGA_C_PBE": pbe_c_e,
    "XC_GGA_X_PBE_SOL": pbesol_x_e,
    "XC_GGA_C_PBE_SOL": pbesol_c_e,
}
MGGA_FUNCS = {
    "XC_MGGA_X_SCAN": scan_x_e,
    "XC_MGGA_C_SCAN": scan_c_e,
}
# bit of each functional in the mask the kernels take (csrc/xc_dual.cuh)
FUNC_BITS = {name: 1 << i for i, name in
             enumerate((*LDA_FUNCS, *GGA_FUNCS, *MGGA_FUNCS))}


def func_mask(names) -> int:
    """The kernels' functional mask of a list of names (a name listed twice
    is summed twice by the JAX package: refused here)."""
    if len(set(names)) != len(names):
        raise ValueError(f"xc functional listed twice: {list(names)}")
    mask = 0
    for name in names:
        if name not in FUNC_BITS:
            raise ValueError(f"xc functional {name} has no kernel")
        mask |= FUNC_BITS[name]
    return mask


def energy(names, nu, nd, suu, sud, sdd, tu=None, td=None):
    """Sum of the named functionals' energies per volume after the _TINY
    floor (xc.py:328-339), summed in the list's order."""
    nu = _floor(nu, TINY)
    nd = _floor(nd, TINY)
    e = torch.zeros_like(nu)
    for name in names:
        if name in LDA_FUNCS:
            e = e + LDA_FUNCS[name](nu, nd)
        elif name in GGA_FUNCS:
            e = e + GGA_FUNCS[name](nu, nd, suu, sud, sdd)
        else:
            e = e + MGGA_FUNCS[name](nu, nd, suu, sud, sdd, tu, td)
    return e


def eval_plain(names, nu, nd, suu=None, sud=None, sdd=None, tu=None,
               td=None):
    """(e, v_up, v_dn, vsigma_uu, vsigma_ud, vsigma_dd, vtau_up, vtau_dn) at
    each point, with the JAX package's libxc-style vacuum handling
    (xc.py:341-379): a channel below DENS_TH is evaluated at the threshold
    with its sigma (and the cross sigma) set to 0, and its potentials,
    vtau included, are masked to 0. tau enters as given."""
    z = torch.zeros_like(nu)
    suu = z if suu is None else suu
    sud = z if sud is None else sud
    sdd = z if sdd is None else sdd
    tu = z if tu is None else tu
    td = z if td is None else td
    up0 = nu < DENS_TH
    dn0 = nd < DENS_TH
    dead = up0 | dn0
    args = [torch.where(up0, DENS_TH, nu), torch.where(dn0, DENS_TH, nd),
            torch.where(up0, 0.0, suu), torch.where(dead, 0.0, sud),
            torch.where(dn0, 0.0, sdd), tu, td]
    args = [a.detach().requires_grad_(True) for a in args]
    with torch.enable_grad():
        e = energy(names, *args)
        grads = torch.autograd.grad(e.sum(), args, allow_unused=True)
    # an argument no functional of the list reads has derivative 0
    vu, vd, vsuu, vsud, vsdd, vtu, vtd = (z if g is None else g
                                          for g in grads)
    return (e.detach(), torch.where(up0, 0.0, vu), torch.where(dn0, 0.0, vd),
            torch.where(up0, 0.0, vsuu), torch.where(dead, 0.0, vsud),
            torch.where(dn0, 0.0, vsdd), torch.where(up0, 0.0, vtu),
            torch.where(dn0, 0.0, vtd))
