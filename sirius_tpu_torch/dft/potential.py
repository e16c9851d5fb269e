"""Effective potential generation (reference: src/potential/potential.cpp:236
Potential::generate): Poisson -> XC -> V_eff assembly, plus the energy
integrals the reference reports (energy.hpp:280).

Mirrors the unpolarized LDA branch of sirius_tpu/dft/potential.py::
generate_potential (:76-228) on device tensors; the XC evaluation is K7,
the space-group symmetrization of V_eff(G) (:167-170) K6.
"""

from __future__ import annotations

import dataclasses

import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
from sirius_tpu_torch.dft.density import GridTables, symmetrize_pw
from sirius_tpu_torch.dft.poisson import hartree_potential_g
from sirius_tpu_torch.dft.xc import XCFunctional


@dataclasses.dataclass
class PotentialResult:
    veff_g: torch.Tensor  # fine G: V_loc + V_H + V_xc
    bz_g: None  # collinear magnetism is not in this slice
    veff_r_coarse: torch.Tensor  # [1, coarse box] V for the H application
    vha_g: torch.Tensor
    vxc_g: torch.Tensor  # fine G: XC potential alone
    energies: dict  # python floats, reference names


def _inner_rr(omega: float, f_r: torch.Tensor, g_r: torch.Tensor) -> float:
    """Real-space integral over the cell: (Omega/N) sum_r f g."""
    return float(torch.sum(f_r * g_r)) * omega / f_r.numel()


def generate_potential(
    ctx: SimulationContext,
    rho_g: torch.Tensor,
    xc: XCFunctional,
    tables: GridTables,
    mag_g=None,
) -> PotentialResult:
    """rho_g: [ng] complex128 on the device of ``tables``."""
    if mag_g is not None or xc.is_gga:
        raise NotImplementedError(
            "polarized and GGA potentials come with ROADMAP queue 1, slice 5")
    dims = tables.dims
    vha_g = hartree_potential_g(rho_g, tables.glen2)
    rho_r = g_to_r(rho_g, tables.fft_index, dims).real
    rho_xc = torch.clamp(rho_r + tables.rho_core_r, min=0.0)
    out = xc.evaluate(rho_xc.reshape(-1))
    vxc_r = out["v"].reshape(dims)
    e_r = out["e"].reshape(dims)
    exc_r = e_r / torch.clamp(rho_xc, min=1e-25)

    vxc_g = r_to_g(vxc_r, tables.fft_index, dims)
    veff_g = tables.vloc_g + vha_g + vxc_g
    if tables.sym is not None:
        veff_g = symmetrize_pw(tables.sym, veff_g)
    veff_r_coarse = g_to_r(veff_g[tables.coarse_to_fine],
                           tables.fft_index_coarse, tables.dims_coarse).real

    vha_r = g_to_r(vha_g, tables.fft_index, dims).real
    veff_r_fine = g_to_r(veff_g, tables.fft_index, dims).real
    om = tables.omega
    energies = {
        "vha": _inner_rr(om, rho_r, vha_r),
        "vxc": _inner_rr(om, rho_r, vxc_r),
        "vloc": _inner_rr(om, rho_r, tables.vloc_r),
        "veff": _inner_rr(om, rho_r, veff_r_fine),
        "exc": _inner_rr(om, rho_r + tables.rho_core_r, exc_r),
        "bxc": 0.0,
        "vtau_tau": 0.0,
    }
    return PotentialResult(
        veff_g=veff_g,
        bz_g=None,
        veff_r_coarse=veff_r_coarse[None].contiguous(),
        vha_g=vha_g,
        vxc_g=vxc_g,
        energies=energies,
    )
