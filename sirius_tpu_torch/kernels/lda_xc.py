"""K7: pointwise LDA exchange-correlation, XC_LDA_X + XC_LDA_C_PZ
(csrc/lda_xc.cu).

lda_xc(nu, nd) -> (e, v_up, v_dn) per point (energy per volume and its
derivatives), and lda_xc_unpolarized(rho) -> (e, v) with n_up = n_dn =
rho/2 and v = (v_up + v_dn)/2 (sirius_tpu/dft/xc.py:403-410). The plain
PyTorch version is torch.autograd over the same energy expression as the
JAX package's jax.grad (xc.py:33-66, :322-379); the kernel evaluates the
closed-form derivatives. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel.
"""

from __future__ import annotations

import math

import torch

from sirius_tpu_torch.kernels import build

TINY = 1e-25
DENS_TH = 1e-13


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


def lda_c_pz_e(nu, nd):
    """Perdew-Zunger 81 correlation energy per volume (xc.py:55-62)."""
    n = nu + nd
    zeta = torch.clamp((nu - nd) / n, -1.0, 1.0)
    rs = (3.0 / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    eu = _pz_eps(rs, False)
    ep = _pz_eps(rs, True)
    return n * (eu + _zeta_f(zeta) * (ep - eu))


def _energy(nu, nd):
    nu = torch.clamp(nu, min=TINY)
    nd = torch.clamp(nd, min=TINY)
    return lda_x_e(nu, nd) + lda_c_pz_e(nu, nd)


def lda_xc_plain(nu, nd):
    up0 = nu < DENS_TH
    dn0 = nd < DENS_TH
    nu_s = torch.where(up0, DENS_TH, nu).detach().requires_grad_(True)
    nd_s = torch.where(dn0, DENS_TH, nd).detach().requires_grad_(True)
    with torch.enable_grad():
        e = _energy(nu_s, nd_s)
        vu, vd = torch.autograd.grad(e.sum(), (nu_s, nd_s))
    return (e.detach(), torch.where(up0, 0.0, vu), torch.where(dn0, 0.0, vd))


def _check(*ts):
    for t in ts:
        if t.dtype != torch.float64 or t.dim() != 1 or t.shape != ts[0].shape \
                or t.device != ts[0].device:
            raise ValueError("lda_xc takes float64 vectors of one length "
                             "on one device")


def _launch(nu, nd, unpolarized: bool):
    n = nu.shape[0]
    nu = nu.contiguous()
    nd = nu if nd is None else nd.contiguous()
    e = torch.empty_like(nu)
    vu = torch.empty_like(nu)
    vd = None if unpolarized else torch.empty_like(nu)
    lib = build.library("lda_xc")
    rc = lib.lda_xc(nu.data_ptr(), nd.data_ptr(), e.data_ptr(), vu.data_ptr(),
                    None if vd is None else vd.data_ptr(), n,
                    int(unpolarized), build.stream_of(nu))
    lda_xc.launches += 1
    build.check(rc, "lda_xc")
    return e, vu, vd


def lda_xc(nu, nd):
    """Polarized X + PZ: (e, v_up, v_dn) at each point."""
    _check(nu, nd)
    if nu.device.type == "cpu":
        return lda_xc_plain(nu, nd)
    if nu.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {nu.device}")
    return _launch(nu, nd, unpolarized=False)


lda_xc.launches = 0


def lda_xc_unpolarized_plain(rho):
    half = 0.5 * rho
    e, vu, vd = lda_xc_plain(half, half)
    return e, 0.5 * (vu + vd)


def lda_xc_unpolarized(rho):
    """Unpolarized X + PZ: (e, v) with n_up = n_dn = rho/2. Launches the
    same kernel as lda_xc (counted on lda_xc.launches)."""
    _check(rho)
    if rho.device.type == "cpu":
        return lda_xc_unpolarized_plain(rho)
    if rho.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {rho.device}")
    e, v, _ = _launch(rho, None, unpolarized=True)
    return e, v
