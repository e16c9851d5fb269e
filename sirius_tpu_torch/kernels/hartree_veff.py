"""K17c: the potential's G-space passes (csrc/potential_passes.cu), and
the plain versions.

hartree_veff(rho_g, glen2, vloc_g, vxc_g) returns (vha_g, veff_g), [ng]
complex128: V_H = 4 pi rho / G^2 (0 where glen2 <= 1e-12, the G = 0 slot)
and V_eff = (V_loc + V_H) + V_xc, in one launch once V_xc(G) exists.
Replaces sirius_tpu/dft/poisson.py::hartree_potential_g (:19-23) and the
sum of sirius_tpu/dft/potential.py::generate_potential_device (:295,
:349); the non-collinear potential takes it too.

gga_inputs(rho_g, core_g, mag_g) returns the rows whose gradients GGA takes
(K10a's input), [1 or 2, ng] complex128: rho + rho_core unpolarized,
[0.5 (rho_tot + m), 0.5 (rho_tot - m)] polarized (rho_tot = rho + rho_core,
or rho without a core charge). Replaces generate_potential_device :306-307
and :334.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import math

import torch

from sirius_tpu_torch.kernels import build

FOUR_PI = 4.0 * math.pi


def hartree_veff_plain(rho_g, glen2, vloc_g, vxc_g):
    nonzero = glen2 > 1e-12
    g2 = torch.where(nonzero, glen2, 1.0)
    v = FOUR_PI * rho_g / g2
    vha = torch.where(nonzero, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device))
    return vha, vloc_g + vha + vxc_g


def gga_inputs_plain(rho_g, core_g, mag_g):
    rho_tot = rho_g if core_g is None else rho_g + core_g
    if mag_g is None:
        return rho_tot[None]
    return torch.stack([0.5 * (rho_tot + mag_g), 0.5 * (rho_tot - mag_g)])


def hartree_veff(rho_g, glen2, vloc_g, vxc_g):
    """(V_H, V_eff) [ng] complex128 (K17c (i) on a CUDA tensor)."""
    if rho_g.dim() != 1:
        raise ValueError("rho_g must be [ng]")
    build.check_fields("hartree_veff", torch.complex128, rho_g,
                       ("rho_g", rho_g), ("vloc_g", vloc_g), ("vxc_g", vxc_g))
    build.check_fields("hartree_veff", torch.float64, rho_g, ("glen2", glen2))
    if not build.on_cuda(rho_g, "hartree_veff"):
        return hartree_veff_plain(rho_g, glen2, vloc_g, vxc_g)
    ng = rho_g.shape[0]
    rho_g, glen2, vloc_g, vxc_g = (t.contiguous()
                                   for t in (rho_g, glen2, vloc_g, vxc_g))
    vha = torch.empty_like(rho_g)
    veff = torch.empty_like(rho_g)
    rc = build.library("potential_passes").hartree_veff(
        rho_g.data_ptr(), glen2.data_ptr(), vloc_g.data_ptr(),
        vxc_g.data_ptr(), FOUR_PI, 1.0, 0.0, ng, vha.data_ptr(),
        veff.data_ptr(),
        build.stream_of(rho_g))
    hartree_veff.launches += 1
    build.check(rc, "hartree_veff")
    return vha, veff


hartree_veff.launches = 0


def gga_inputs(rho_g, core_g, mag_g):
    """The GGA gradient rows [1 or 2, ng] complex128 (K17c (ii) on a CUDA
    tensor). With neither a core charge nor m there is nothing to compute:
    rho_g[None] comes back, with no launch."""
    if rho_g.dim() != 1:
        raise ValueError("rho_g must be [ng]")
    build.check_fields("gga_inputs", torch.complex128, rho_g,
                       ("rho_g", rho_g), ("core_g", core_g), ("mag_g", mag_g))
    if core_g is None and mag_g is None:
        return rho_g[None]
    if not build.on_cuda(rho_g, "gga_inputs"):
        return gga_inputs_plain(rho_g, core_g, mag_g)
    ng = rho_g.shape[0]
    rho_g, core_g, mag_g = (None if t is None else t.contiguous()
                            for t in (rho_g, core_g, mag_g))
    out = torch.empty((1 if mag_g is None else 2, ng),
                      dtype=torch.complex128, device=rho_g.device)
    rc = build.library("potential_passes").gga_inputs(
        rho_g.data_ptr(), build.ptr(core_g), build.ptr(mag_g), 0.5, 1.0,
        0.0, ng, out.data_ptr(), build.stream_of(rho_g))
    gga_inputs.launches += 1
    build.check(rc, "gga_inputs")
    return out


gga_inputs.launches = 0
