"""K7 / K7b: pointwise LDA exchange-correlation for any sum of XC_LDA_X,
XC_LDA_C_PZ, XC_LDA_C_PW and XC_LDA_C_VWN (csrc/lda_xc.cu).

lda_xc(nu, nd, names) -> (e, v_up, v_dn) per point (energy per volume and
its derivatives), and lda_xc_unpolarized(rho, names) -> (e, v) with
n_up = n_dn = rho/2 and v = (v_up + v_dn)/2 (sirius_tpu/dft/xc.py:399-415).
names defaults to X + PZ. The plain PyTorch version is torch.autograd over
the JAX package's energy expressions (kernels/xc_functionals.py); the
kernel evaluates X + PZ in closed form and every other sum on dual numbers.
Unpolarized X + PZ launches its own kernel, the closed form at zeta = 0,
which gives the bits of the polarized launch at (rho/2, rho/2): e and v_up.
Every launch counts on lda_xc.launches, that one also on
lda_xc.launches_pz_unpolarized.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels.xc_functionals import (LDA_FUNCS, eval_plain,
                                                    func_mask)

X_PZ = ("XC_LDA_X", "XC_LDA_C_PZ")


def _lda_mask(names) -> int:
    bad = [n for n in names if n not in LDA_FUNCS]
    if bad or not names:
        raise ValueError(f"lda_xc evaluates LDA functionals only, got "
                         f"{list(names)}")
    return func_mask(names)


def lda_xc_plain(nu, nd, names=X_PZ):
    e, vu, vd, *_ = eval_plain(list(names), nu, nd)
    return e, vu, vd


def _check(*ts):
    for t in ts:
        if t.dtype != torch.float64 or t.dim() != 1 or t.shape != ts[0].shape \
                or t.device != ts[0].device:
            raise ValueError("lda_xc takes float64 vectors of one length "
                             "on one device")


def _launch(nu, nd, unpolarized: bool, mask: int):
    n = nu.shape[0]
    nu = nu.contiguous()
    nd = nu if nd is None else nd.contiguous()
    e = torch.empty_like(nu)
    vu = torch.empty_like(nu)
    vd = None if unpolarized else torch.empty_like(nu)
    lib = build.library("lda_xc")
    rc = lib.lda_xc(nu.data_ptr(), nd.data_ptr(), e.data_ptr(), vu.data_ptr(),
                    None if vd is None else vd.data_ptr(), n,
                    int(unpolarized), mask, build.stream_of(nu))
    lda_xc.launches += 1
    if unpolarized and mask == func_mask(X_PZ):
        lda_xc.launches_pz_unpolarized += 1
    build.check(rc, "lda_xc")
    return e, vu, vd


def lda_xc(nu, nd, names=X_PZ):
    """Polarized LDA sum: (e, v_up, v_dn) at each point."""
    mask = _lda_mask(names)
    _check(nu, nd)
    if nu.device.type == "cpu":
        return lda_xc_plain(nu, nd, names)
    if nu.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {nu.device}")
    return _launch(nu, nd, False, mask)


lda_xc.launches = lda_xc.launches_pz_unpolarized = 0


def lda_xc_unpolarized_plain(rho, names=X_PZ):
    half = 0.5 * rho
    e, vu, vd = lda_xc_plain(half, half, names)
    return e, 0.5 * (vu + vd)


def lda_xc_unpolarized(rho, names=X_PZ):
    """Unpolarized LDA sum: (e, v) with n_up = n_dn = rho/2. Launches the
    kernel of lda_xc, or for X + PZ its zeta = 0 form (counted on
    lda_xc.launches, the latter also on lda_xc.launches_pz_unpolarized)."""
    mask = _lda_mask(names)
    _check(rho)
    if rho.device.type == "cpu":
        return lda_xc_unpolarized_plain(rho, names)
    if rho.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {rho.device}")
    e, v, _ = _launch(rho, None, True, mask)
    return e, v
