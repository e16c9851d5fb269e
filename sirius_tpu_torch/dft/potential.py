"""Effective potential generation (reference: src/potential/potential.cpp:236
Potential::generate): Poisson -> XC (unpolarized or collinear) -> V_eff
assembly, plus the energy integrals the reference reports (energy.hpp:280).

Mirrors sirius_tpu/dft/potential.py::generate_potential (:76-228; the
device form :256-383 is the same arithmetic for LDA and GGA) on device
tensors. Collinear magnetism follows the reference's layout: charge rho
and magnetization m_z; the XC potential splits into the charge part V_xc
and the field B_z = (V_up - V_dn)/2, which enters the two spin channels
with opposite signs. The XC evaluation is K7 / K7b (LDA), K7g (GGA) or K7s
(SCAN meta-GGA, which also reads the kinetic-energy density tau and
returns v_tau); the gradient and divergence of GGA and mGGA are K10a /
K10b around cuFFT, and the space-group symmetrization of V_eff(G) and
B_z(G) (the latter as an axial field) is K6. v_tau is not symmetrized, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
from sirius_tpu_torch.dft.density import GridTables, symmetrize_pw
from sirius_tpu_torch.dft.poisson import hartree_potential_g
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels.xc_gradient import divergence_pw, gradient_boxes


@dataclasses.dataclass
class PotentialResult:
    veff_g: torch.Tensor  # fine G: charge part (V_loc + V_H + V_xc)
    bz_g: torch.Tensor | None  # fine G: z field B_z (collinear) or None
    veff_r_coarse: torch.Tensor  # [ns, coarse box] per-spin V (V + B, V - B)
    vha_g: torch.Tensor
    vxc_g: torch.Tensor  # fine G: XC potential alone
    energies: dict  # python floats, reference names
    # mGGA only: per-spin v_tau = de/dtau on the coarse box for the
    # -1/2 div(v_tau grad) operator (ops/mgga.py); None otherwise
    vtau_r_coarse: torch.Tensor | None = None


def _inner_rr(omega: float, f_r: torch.Tensor, g_r: torch.Tensor) -> float:
    """Real-space integral over the cell: (Omega/N) sum_r f g."""
    return float(torch.sum(f_r * g_r)) * omega / f_r.numel()


def gradient_r(tables: GridTables, f_g: torch.Tensor) -> torch.Tensor:
    """grad f of fields f_g [S, ng] as real boxes [S, 3, n1, n2, n3]: the
    boxes of i G_c f (K10a), the inverse FFT, the real part
    (potential.py:57-61)."""
    dims = tables.dims
    s = f_g.shape[0]
    n = dims[0] * dims[1] * dims[2]
    box = gradient_boxes(f_g, tables.gcart, tables.fft_index, n,
                         tables.box_to_g)
    fr = torch.fft.ifftn(box.view((s, 3) + dims), dim=(-3, -2, -1),
                         norm="forward")
    del box
    return fr.real.contiguous()


def divergence_g(tables: GridTables, vec_r: torch.Tensor) -> torch.Tensor:
    """div of real vector fields vec_r [S, 3, n1, n2, n3] in G space, [S, ng]:
    the forward FFT of each component, then sum_c i G_c F_c(G) (K10b)
    (potential.py:64-69)."""
    dims = tables.dims
    s = vec_r.shape[0]
    n = dims[0] * dims[1] * dims[2]
    box = torch.fft.fftn(vec_r.to(torch.complex128), dim=(-3, -2, -1),
                         norm="forward")
    return divergence_pw(box.view(s, 3, n), tables.gcart, tables.fft_index)


def generate_potential(
    ctx: SimulationContext,
    rho_g: torch.Tensor,
    xc: XCFunctional,
    tables: GridTables,
    mag_g: torch.Tensor | None = None,
    tau_g: torch.Tensor | None = None,
) -> PotentialResult:
    """rho_g (and mag_g, the z magnetization of a collinear run): [ng]
    complex128 on the device of ``tables``. tau_g (mGGA only): the per-spin
    kinetic-energy density [ns, ng] on the fine G set (ops/mgga.tau_kset
    through density_from_coarse_acc); unpolarized its one row is the total
    tau."""
    dims = tables.dims
    npt = dims[0] * dims[1] * dims[2]
    ng_fine = rho_g.shape[-1]
    polarized = mag_g is not None
    if xc.is_mgga and tau_g is None:
        raise ValueError("mGGA functional needs tau_g")
    vha_g = hartree_potential_g(rho_g, tables.glen2)
    rho_r = g_to_r(rho_g, tables.fft_index, dims).real
    rho_core_r = tables.rho_core_r
    # the densities whose gradients GGA takes, with the core charge
    rho_tot_g = rho_g if tables.rho_core_g is None else rho_g + tables.rho_core_g

    def to_r(f_g):
        return g_to_r(f_g, tables.fft_index, dims).real

    tau_r = None  # mGGA: tau per spin on the fine box
    if xc.is_mgga:
        tau_r = torch.stack([to_r(t) for t in tau_g.reshape(-1, ng_fine)])
    vtau = None  # mGGA: v_tau per spin on the fine box, [ns, npt]
    if polarized:
        mag_r = to_r(mag_g)
        # clip |m| <= rho_xc (reference density guard) and split the
        # channels; the core charge is unpolarized and split evenly
        rho_xc = torch.clamp(rho_r + rho_core_r, min=1e-20)
        m = torch.minimum(torch.maximum(mag_r, -rho_xc), rho_xc)
        n_up = (0.5 * (rho_xc + m)).reshape(-1)
        n_dn = (0.5 * (rho_xc - m)).reshape(-1)
        if xc.is_gga:
            # gradients of the UNCLIPPED spin densities (potential.py:110-115)
            g = gradient_r(tables, torch.stack([0.5 * (rho_tot_g + mag_g),
                                                0.5 * (rho_tot_g - mag_g)]))
            gu, gd = g[0].view(3, npt), g[1].view(3, npt)
            if xc.is_mgga:
                e, v_up, v_dn, fu, fd, vtu, vtd = xc.evaluate_mgga_polarized(
                    n_up, n_dn, gu, gd, tau_r[0].reshape(-1),
                    tau_r[1].reshape(-1))
                vtau = torch.stack([vtu, vtd])
            else:
                e, v_up, v_dn, fu, fd = xc.evaluate_gga_polarized(
                    n_up, n_dn, gu, gd)
            del g, gu, gd
            # v_s -= div(2 vsigma_ss grad n_s + vsigma_ud grad n_s')
            div = to_r(divergence_g(tables, torch.stack([fu, fd]).view(
                (2, 3) + dims)))
            del fu, fd
            v_up = v_up.view(dims) - div[0]
            v_dn = v_dn.view(dims) - div[1]
        else:
            out = xc.evaluate_polarized(n_up, n_dn)
            e, v_up, v_dn = out["e"], out["v_up"], out["v_dn"]
        e_r = e.view(dims)
        v_up = v_up.view(dims)
        v_dn = v_dn.view(dims)
        vxc_r = 0.5 * (v_up + v_dn)
        bz_r = 0.5 * (v_up - v_dn)
    else:
        rho_xc = torch.clamp(rho_r + rho_core_r, min=0.0)
        if xc.is_gga:
            g = gradient_r(tables, rho_tot_g[None])[0].view(3, npt)
            if xc.is_mgga:
                e, v, flux, vt = xc.evaluate_mgga(rho_xc.reshape(-1), g,
                                                  tau_r[0].reshape(-1))
                vtau = vt[None]
            else:
                e, v, flux = xc.evaluate_gga(rho_xc.reshape(-1), g)
            del g
            vxc_r = v.view(dims) - to_r(divergence_g(
                tables, flux.view((1, 3) + dims))[0])
        else:
            out = xc.evaluate(rho_xc.reshape(-1))
            e, vxc_r = out["e"], out["v"].view(dims)
        e_r = e.view(dims)
        bz_r = None
    exc_r = e_r / torch.clamp(rho_xc, min=1e-25)

    vxc_g = r_to_g(vxc_r, tables.fft_index, dims)
    veff_g = tables.vloc_g + vha_g + vxc_g
    bz_g = r_to_g(bz_r, tables.fft_index, dims) if polarized else None
    if tables.sym is not None:
        veff_g = symmetrize_pw(tables.sym, veff_g)
        if polarized:
            bz_g = symmetrize_pw(tables.sym, bz_g, axial_z=True)

    def to_coarse(f_g):
        return g_to_r(f_g[tables.coarse_to_fine], tables.fft_index_coarse,
                      tables.dims_coarse).real

    v_r = to_coarse(veff_g)
    if polarized:
        b_r = to_coarse(bz_g)
        veff_r_coarse = torch.stack([v_r + b_r, v_r - b_r])
    else:
        veff_r_coarse = v_r[None].contiguous()

    # mGGA: v_tau per spin, smoothed through the coarse G set for the
    # -1/2 div(v_tau grad) operator, and the int v_tau tau integral that the
    # eval_sum double-counting correction needs (potential.py:189-205)
    vtau_r_coarse = None
    e_vtau_tau = 0.0
    if vtau is not None:
        vtau_r_coarse = torch.stack([
            to_coarse(r_to_g(v.view(dims), tables.fft_index, dims))
            for v in vtau])
        e_vtau_tau = sum(_inner_rr(tables.omega, tau_r[s], vtau[s].view(dims))
                         for s in range(vtau.shape[0]))

    vha_r = to_r(vha_g)
    veff_r_fine = to_r(veff_g)
    om = tables.omega
    energies = {
        "vha": _inner_rr(om, rho_r, vha_r),
        "vxc": _inner_rr(om, rho_r, vxc_r),
        "vloc": _inner_rr(om, rho_r, tables.vloc_r),
        "veff": _inner_rr(om, rho_r, veff_r_fine),
        "exc": _inner_rr(om, rho_r + rho_core_r, exc_r),
        "bxc": _inner_rr(om, mag_r, to_r(bz_g)) if polarized else 0.0,
        "vtau_tau": e_vtau_tau,
    }
    return PotentialResult(
        veff_g=veff_g,
        bz_g=bz_g,
        veff_r_coarse=veff_r_coarse,
        vha_g=vha_g,
        vxc_g=vxc_g,
        energies=energies,
        vtau_r_coarse=vtau_r_coarse,
    )
