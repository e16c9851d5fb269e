"""K7s: pointwise SCAN meta-GGA exchange-correlation fused with the flux
products of the divergence term (csrc/mgga_xc.cu).

mgga_xc(nu, nd, gu, gd, tu, td, names) ->
    (e, v_up, v_dn, flux_up, flux_dn, vtau_up, vtau_dn):
nu, nd [N] the (clipped) spin densities, gu, gd [3, N] the gradients of the
unclipped spin densities, tu, td [N] the spin kinetic-energy densities;
sigma is formed from the gradients, and flux_up = 2 vsigma_uu gu +
vsigma_ud gd, flux_dn = 2 vsigma_dd gd + vsigma_ud gu [3, N]
(sirius_tpu/dft/potential.py:110-137).
mgga_xc_unpolarized(rho, g, tau, names) -> (e, v, flux, vtau) with
flux = 2 vsigma g and tau the total kinetic-energy density
(potential.py:144-155, xc.py:399-415). names: SCAN exchange and / or
correlation, with any LDA and PBE-family functionals besides
(kernels/xc_functionals.py), all summed in one launch.

The kernel has one instantiation for the functional set the port's decks
run (COMPILED_SETS: SCAN exchange plus correlation) and runtime-mask ones
for every other legal list; instantiation(names) picks it. Each launch
counts on mgga_xc.launches and on the instantiation's own counter
(launches_scan, launches_mask).

The plain PyTorch version forms sigma as the JAX package does, takes e, v,
vsigma and vtau from torch.autograd over the JAX package's energy
expressions (xc_functionals.eval_plain) and forms the products. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels.gga_xc import _sigma
from sirius_tpu_torch.kernels.xc_functionals import (MGGA_FUNCS, eval_plain,
                                                    func_mask)


def _mgga_mask(names) -> int:
    if not any(n in MGGA_FUNCS for n in names):
        raise ValueError(f"mgga_xc needs a SCAN functional, got {list(names)}")
    return func_mask(names)


# the functional set compiled as its own instantiation, by mask: (name, the
# set number csrc/mgga_xc.cu takes)
COMPILED_SETS = {func_mask(["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]): ("scan", 1)}
MASK_SET = ("mask", 0)


def instantiation(names) -> tuple[str, int]:
    """(name, set number) of the kernel instantiation a functional list
    runs: its compiled set, else the runtime mask."""
    return COMPILED_SETS.get(_mgga_mask(names), MASK_SET)


def mgga_xc_plain(nu, nd, gu, gd, tu, td, names):
    e, vu, vd, vsuu, vsud, vsdd, vtu, vtd = eval_plain(
        list(names), nu, nd, _sigma(gu, gu), _sigma(gu, gd), _sigma(gd, gd),
        tu, td)
    fu = (2 * vsuu) * gu + vsud * gd
    fd = (2 * vsdd) * gd + vsud * gu
    return e, vu, vd, fu, fd, vtu, vtd


def mgga_xc_unpolarized_plain(rho, g, tau, names):
    half = 0.5 * rho
    s4 = 0.25 * _sigma(g, g)
    t2 = 0.5 * tau
    e, vu, vd, vsuu, vsud, vsdd, vtu, vtd = eval_plain(
        list(names), half, half, s4, s4, s4, t2, t2)
    vs = 0.25 * (vsuu + vsud + vsdd)
    return e, 0.5 * (vu + vd), (2.0 * vs) * g, 0.5 * (vtu + vtd)


def _check(n, fields, grads):
    for t in fields:
        if t.dtype != torch.float64 or tuple(t.shape) != (n,):
            raise ValueError(f"mgga_xc: densities and tau must be float64 "
                             f"[{n}]")
    for t in grads:
        if t.dtype != torch.float64 or tuple(t.shape) != (3, n):
            raise ValueError(f"mgga_xc: gradients must be float64 [3, {n}]")
    dev = fields[0].device
    if any(t.device != dev for t in (*fields, *grads)):
        raise ValueError("mgga_xc: inputs on more than one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"mgga_xc: unsupported device {dev}")
    return dev.type == "cuda"


def _launch(nu, nd, gu, gd, tu, td, names):
    unpolarized = nd is None
    n = nu.shape[0]
    nu, gu, tu = nu.contiguous(), gu.contiguous(), tu.contiguous()
    nd = nu if unpolarized else nd.contiguous()
    gd = gu if unpolarized else gd.contiguous()
    td = tu if unpolarized else td.contiguous()
    e = torch.empty_like(nu)
    vu = torch.empty_like(nu)
    fu = torch.empty_like(gu)
    vtu = torch.empty_like(nu)
    vd = None if unpolarized else torch.empty_like(nu)
    fd = None if unpolarized else torch.empty_like(gu)
    vtd = None if unpolarized else torch.empty_like(nu)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kind, number = instantiation(names)
    lib = build.library("mgga_xc")
    rc = lib.mgga_xc(ptr(nu), ptr(nd), ptr(gu), ptr(gd), ptr(tu), ptr(td),
                     ptr(e), ptr(vu), ptr(vd), ptr(fu), ptr(fd), ptr(vtu),
                     ptr(vtd), n, int(unpolarized), func_mask(names), number,
                     build.stream_of(nu))
    mgga_xc.launches += 1
    build.count_launch(mgga_xc, "_" + kind)
    build.check(rc, "mgga_xc")
    return e, vu, vd, fu, fd, vtu, vtd


def mgga_xc(nu, nd, gu, gd, tu, td, names):
    """Polarized: (e, v_up, v_dn, flux_up, flux_dn, vtau_up, vtau_dn)."""
    _mgga_mask(names)
    if not _check(nu.shape[0], (nu, nd, tu, td), (gu, gd)):
        return mgga_xc_plain(nu, nd, gu, gd, tu, td, names)
    return _launch(nu, nd, gu, gd, tu, td, names)


mgga_xc.launches = 0
mgga_xc.launches_scan = mgga_xc.launches_mask = 0


def mgga_xc_unpolarized(rho, g, tau, names):
    """Unpolarized: (e, v, flux, vtau). Launches the same kernel as mgga_xc
    (counted on mgga_xc's counters)."""
    _mgga_mask(names)
    if not _check(rho.shape[0], (rho, tau), (g,)):
        return mgga_xc_unpolarized_plain(rho, g, tau, names)
    e, v, _, f, _, vt, _ = _launch(rho, None, g, None, tau, None, names)
    return e, v, f, vt
