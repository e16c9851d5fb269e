"""K7 / K7b: pointwise LDA exchange-correlation for any sum of XC_LDA_X,
XC_LDA_C_PZ, XC_LDA_C_PW and XC_LDA_C_VWN (csrc/lda_xc.cu).

lda_xc(nu, nd, names) -> (e, v_up, v_dn) per point (energy per volume and
its derivatives), and lda_xc_unpolarized(rho, names) -> (e, v) with
n_up = n_dn = rho/2 and v = (v_up + v_dn)/2 (sirius_tpu/dft/xc.py:399-415).
names defaults to X + PZ. The plain PyTorch version is torch.autograd over
the JAX package's energy expressions (kernels/xc_functionals.py).

The kernel has one instantiation for each functional set the port's decks
run (COMPILED_SETS: X + PZ in closed form, X + PW92 and X + VWN5 as
compiled sets) and a runtime-mask one, on dual numbers, for every other
LDA list; instantiation(names) picks it. X + PZ launches its closed form
at zeta = 0 unpolarized and its own polarized kernel, which at n_up = n_dn
gives the zeta = 0 kernel's bits. Each launch counts on lda_xc.launches
and on its instantiation's counter: launches_pz_unpolarized,
launches_pz_polarized, launches_pw92, launches_vwn, launches_mask.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels.xc_functionals import (LDA_FUNCS, eval_plain,
                                                    func_mask)

X_PZ = ("XC_LDA_X", "XC_LDA_C_PZ")
PW92 = ("XC_LDA_X", "XC_LDA_C_PW")
VWN = ("XC_LDA_X", "XC_LDA_C_VWN")


def _lda_mask(names) -> int:
    bad = [n for n in names if n not in LDA_FUNCS]
    if bad or not names:
        raise ValueError(f"lda_xc evaluates LDA functionals only, got "
                         f"{list(names)}")
    return func_mask(names)


# the functional sets compiled as their own instantiations, by mask: (name,
# the set number csrc/lda_xc.cu takes)
COMPILED_SETS = {
    func_mask(X_PZ): ("pz", 1),
    func_mask(PW92): ("pw92", 2),
    func_mask(VWN): ("vwn", 3),
}
MASK_SET = ("mask", 0)


def instantiation(names) -> tuple[str, int]:
    """(name, set number) of the kernel instantiation a functional list
    runs: its compiled set, else the runtime mask."""
    return COMPILED_SETS.get(_lda_mask(names), MASK_SET)


def lda_xc_plain(nu, nd, names=X_PZ):
    e, vu, vd, *_ = eval_plain(list(names), nu, nd)
    return e, vu, vd


def _check(*ts):
    for t in ts:
        if t.dtype != torch.float64 or t.dim() != 1 or t.shape != ts[0].shape \
                or t.device != ts[0].device:
            raise ValueError("lda_xc takes float64 vectors of one length "
                             "on one device")


def _launch(nu, nd, unpolarized: bool, names):
    kind, number = instantiation(names)
    n = nu.shape[0]
    nu = nu.contiguous()
    nd = nu if nd is None else nd.contiguous()
    e = torch.empty_like(nu)
    vu = torch.empty_like(nu)
    vd = None if unpolarized else torch.empty_like(nu)
    lib = build.library("lda_xc")
    rc = lib.lda_xc(nu.data_ptr(), nd.data_ptr(), e.data_ptr(), vu.data_ptr(),
                    None if vd is None else vd.data_ptr(), n,
                    int(unpolarized), func_mask(names), number,
                    build.stream_of(nu))
    lda_xc.launches += 1
    if kind == "pz":
        kind += "_unpolarized" if unpolarized else "_polarized"
    build.count_launch(lda_xc, "_" + kind)
    build.check(rc, "lda_xc")
    return e, vu, vd


def lda_xc(nu, nd, names=X_PZ):
    """Polarized LDA sum: (e, v_up, v_dn) at each point."""
    _lda_mask(names)
    _check(nu, nd)
    if nu.device.type == "cpu":
        return lda_xc_plain(nu, nd, names)
    if nu.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {nu.device}")
    return _launch(nu, nd, False, names)


lda_xc.launches = lda_xc.launches_pz_unpolarized = 0
lda_xc.launches_pz_polarized = lda_xc.launches_pw92 = 0
lda_xc.launches_vwn = lda_xc.launches_mask = 0


def lda_xc_unpolarized_plain(rho, names=X_PZ):
    half = 0.5 * rho
    e, vu, vd = lda_xc_plain(half, half, names)
    return e, 0.5 * (vu + vd)


def lda_xc_unpolarized(rho, names=X_PZ):
    """Unpolarized LDA sum: (e, v) with n_up = n_dn = rho/2. Launches the
    unpolarized form of the list's instantiation (counted on lda_xc's
    counters; X + PZ on lda_xc.launches_pz_unpolarized)."""
    _lda_mask(names)
    _check(rho)
    if rho.device.type == "cpu":
        return lda_xc_unpolarized_plain(rho, names)
    if rho.device.type != "cuda":
        raise RuntimeError(f"lda_xc: unsupported device {rho.device}")
    e, v, _ = _launch(rho, None, True, names)
    return e, v
