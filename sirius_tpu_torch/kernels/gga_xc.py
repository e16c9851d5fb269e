"""K7g: pointwise GGA exchange-correlation fused with the flux products of
the divergence term (csrc/gga_xc.cu).

gga_xc(nu, nd, gu, gd, names) -> (e, v_up, v_dn, flux_up, flux_dn):
nu, nd [N] the (clipped) spin densities, gu, gd [3, N] the gradients of the
unclipped spin densities; sigma is formed from the gradients, and
flux_up = 2 vsigma_uu gu + vsigma_ud gd, flux_dn = 2 vsigma_dd gd +
vsigma_ud gu [3, N] (sirius_tpu/dft/potential.py:110-137).
gga_xc_unpolarized(rho, g, names) -> (e, v, flux) with flux = 2 vsigma g
(potential.py:144-160). names: any sum of the LDA and PBE-family
functionals (kernels/xc_functionals.py).

The kernel has one instantiation for each functional set the port's
decks run (COMPILED_SETS: PBE and PBEsol exchange plus correlation) and a
runtime-mask one for every other legal list; instantiation(names) picks
it. Each launch counts on gga_xc.launches and on the instantiation's own
counter (launches_pbe, launches_pbesol, launches_mask).

The plain PyTorch version forms sigma as the JAX package does, takes e, v
and vsigma from torch.autograd over the JAX package's energy expressions
(xc_functionals.eval_plain) and forms the products. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels.xc_functionals import (MGGA_FUNCS, eval_plain,
                                                    func_mask)


def _sigma(a, b):
    # component 0 first, from zero, as potential.py:116-118 sums them
    s = torch.zeros_like(a[0])
    for c in range(3):
        s = s + a[c] * b[c]
    return s


def gga_xc_plain(nu, nd, gu, gd, names):
    e, vu, vd, vsuu, vsud, vsdd, *_ = eval_plain(
        list(names), nu, nd, _sigma(gu, gu), _sigma(gu, gd), _sigma(gd, gd))
    fu = (2 * vsuu) * gu + vsud * gd
    fd = (2 * vsdd) * gd + vsud * gu
    return e, vu, vd, fu, fd


def gga_xc_unpolarized_plain(rho, g, names):
    half = 0.5 * rho
    s4 = 0.25 * _sigma(g, g)
    e, vu, vd, vsuu, vsud, vsdd, *_ = eval_plain(list(names), half, half, s4,
                                                 s4, s4)
    vs = 0.25 * (vsuu + vsud + vsdd)
    return e, 0.5 * (vu + vd), (2.0 * vs) * g


def _gga_mask(names) -> int:
    bad = [n for n in names if n in MGGA_FUNCS]
    if bad:
        raise ValueError(f"gga_xc has no tau: {bad} run through mgga_xc")
    return func_mask(names)


# the functional sets compiled as their own instantiations, by mask: (name,
# the set number csrc/gga_xc.cu takes)
COMPILED_SETS = {
    func_mask(["XC_GGA_X_PBE", "XC_GGA_C_PBE"]): ("pbe", 1),
    func_mask(["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"]): ("pbesol", 2),
}
MASK_SET = ("mask", 0)


def instantiation(names) -> tuple[str, int]:
    """(name, set number) of the kernel instantiation a functional list
    runs: its compiled set, else the runtime mask."""
    return COMPILED_SETS.get(_gga_mask(names), MASK_SET)


def _check(n, fields, grads):
    for t in fields:
        if t.dtype != torch.float64 or tuple(t.shape) != (n,):
            raise ValueError(f"gga_xc: densities must be float64 [{n}]")
    for t in grads:
        if t.dtype != torch.float64 or tuple(t.shape) != (3, n):
            raise ValueError(f"gga_xc: gradients must be float64 [3, {n}]")
    dev = fields[0].device
    if any(t.device != dev for t in (*fields, *grads)):
        raise ValueError("gga_xc: inputs on more than one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"gga_xc: unsupported device {dev}")
    return dev.type == "cuda"


def _launch(nu, nd, gu, gd, names):
    unpolarized = nd is None
    n = nu.shape[0]
    nu, gu = nu.contiguous(), gu.contiguous()
    nd = nu if unpolarized else nd.contiguous()
    gd = gu if unpolarized else gd.contiguous()
    e = torch.empty_like(nu)
    vu = torch.empty_like(nu)
    fu = torch.empty_like(gu)
    vd = None if unpolarized else torch.empty_like(nu)
    fd = None if unpolarized else torch.empty_like(gu)
    kind, number = instantiation(names)
    lib = build.library("gga_xc")
    rc = lib.gga_xc(nu.data_ptr(), nd.data_ptr(), gu.data_ptr(), gd.data_ptr(),
                    e.data_ptr(), vu.data_ptr(),
                    None if vd is None else vd.data_ptr(), fu.data_ptr(),
                    None if fd is None else fd.data_ptr(), n,
                    int(unpolarized), func_mask(names), number,
                    build.stream_of(nu))
    gga_xc.launches += 1
    build.count_launch(gga_xc, "_" + kind)
    build.check(rc, "gga_xc")
    return e, vu, vd, fu, fd


def gga_xc(nu, nd, gu, gd, names):
    """Polarized: (e, v_up, v_dn, flux_up, flux_dn)."""
    _gga_mask(names)
    if not _check(nu.shape[0], (nu, nd), (gu, gd)):
        return gga_xc_plain(nu, nd, gu, gd, names)
    return _launch(nu, nd, gu, gd, names)


gga_xc.launches = 0
gga_xc.launches_pbe = gga_xc.launches_pbesol = gga_xc.launches_mask = 0


def gga_xc_unpolarized(rho, g, names):
    """Unpolarized: (e, v, flux). Launches the same kernel as gga_xc
    (counted on gga_xc's counters)."""
    _gga_mask(names)
    if not _check(rho.shape[0], (rho,), (g,)):
        return gga_xc_unpolarized_plain(rho, g, names)
    e, v, _, f, _ = _launch(rho, None, g, None, names)
    return e, v, f
