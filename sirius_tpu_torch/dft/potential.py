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
in the JAX package. The pointwise passes between them are K17: K17a the
XC inputs (kernels/xc_inputs.py), K17b the XC outputs
(kernels/xc_outputs.py), K17c the Hartree potential with the V_eff sum and
GGA's gradient rows (kernels/hartree_veff.py), K17d the coarse boxes and
the per-spin coarse potential (kernels/coarse_potential.py).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import box_to_g, g_to_r, r_to_g
from sirius_tpu_torch.dft.density import GridTables, symmetrize_pw
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels.coarse_potential import coarse_fill, coarse_stack
from sirius_tpu_torch.kernels.hartree_veff import gga_inputs, hartree_veff
from sirius_tpu_torch.kernels.xc_gradient import divergence_pw, gradient_boxes
from sirius_tpu_torch.kernels.xc_inputs import (
    FLOOR_POLARIZED,
    FLOOR_UNPOLARIZED,
    xc_inputs,
)
from sirius_tpu_torch.kernels.xc_outputs import xc_outputs


@dataclasses.dataclass
class PotentialResult:
    veff_g: torch.Tensor  # fine G: charge part (V_loc + V_H + V_xc)
    bz_g: torch.Tensor | None  # fine G: z field B_z (collinear) or None
    veff_r_coarse: torch.Tensor  # [ns, coarse box] per-spin V (V + B, V - B)
    vha_g: torch.Tensor
    vxc_g: torch.Tensor  # fine G: XC potential alone
    # the energy integrals under the reference's names, each a list of the
    # box pairs (f_r, g_r) of (Omega/N) sum_r f g (empty: zero); the fused
    # step reduces them in K15, the host loop through `energies`
    integrands: dict
    omega: float
    # mGGA only: per-spin v_tau = de/dtau on the coarse box for the
    # -1/2 div(v_tau grad) operator (ops/mgga.py); None otherwise
    vtau_r_coarse: torch.Tensor | None = None

    @functools.cached_property
    def energies(self) -> dict:
        """The energy integrals (energy.hpp:280) as 0-d float64 tensors on
        the device, reduced on first use."""
        zero = torch.zeros((), dtype=torch.float64,
                           device=self.veff_g.device)
        return {name: sum((_inner_rr(self.omega, f, g) for f, g in pairs),
                          zero)
                for name, pairs in self.integrands.items()}


def energies_host(pot) -> dict:
    """pot.energies as python floats, in one readback."""
    names = list(pot.energies)
    values = torch.stack([pot.energies[k] for k in names]).tolist()
    return dict(zip(names, values))


def _inner_rr(omega: float, f_r: torch.Tensor,
              g_r: torch.Tensor) -> torch.Tensor:
    """Real-space integral over the cell: (Omega/N) sum_r f g, a 0-d
    tensor."""
    return torch.sum(f_r * g_r) * omega / f_r.numel()


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

    def to_r(f_g):
        return g_to_r(f_g, tables.fft_index, dims).real

    # K17a: rho_r, rho + rho_core, the clamped rho_xc and (collinear) |m|
    # clipped to rho_xc and the channels split, the core charge evenly
    inp = xc_inputs(g_to_r(rho_g, tables.fft_index, dims),
                    None if tables.rho_core_g is None else tables.rho_core_r,
                    g_to_r(mag_g, tables.fft_index, dims) if polarized
                    else None,
                    FLOOR_POLARIZED if polarized else FLOOR_UNPOLARIZED)
    rho_r, rho_xc = inp.rho_r, inp.rho_xc

    tau_r = None  # mGGA: tau per spin on the fine box
    if xc.is_mgga:
        tau_r = torch.stack([to_r(t) for t in tau_g.reshape(-1, ng_fine)])
    vtau = None  # mGGA: v_tau per spin on the fine box, [ns, npt]
    div = None  # GGA: the inverse-transformed divergence boxes
    if xc.is_gga:
        # gradients of the UNCLIPPED densities with the core charge
        # (potential.py:110-115); K17c (ii) forms the rows
        g = gradient_r(tables, gga_inputs(rho_g, tables.rho_core_g, mag_g))
    if polarized:
        n_up, n_dn = inp.n_up.reshape(-1), inp.n_dn.reshape(-1)
        if xc.is_gga:
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
            div = g_to_r(divergence_g(tables, torch.stack([fu, fd]).view(
                (2, 3) + dims)), tables.fft_index, dims)
            del fu, fd
        else:
            out = xc.evaluate_polarized(n_up, n_dn)
            e, v_up, v_dn = out["e"], out["v_up"], out["v_dn"]
    else:
        v_dn = None
        if xc.is_gga:
            g = g[0].view(3, npt)
            if xc.is_mgga:
                e, v_up, flux, vt = xc.evaluate_mgga(rho_xc.reshape(-1), g,
                                                     tau_r[0].reshape(-1))
                vtau = vt[None]
            else:
                e, v_up, flux = xc.evaluate_gga(rho_xc.reshape(-1), g)
            del g
            div = g_to_r(divergence_g(tables, flux.view((1, 3) + dims))[0],
                         tables.fft_index, dims)[None]
        else:
            out = xc.evaluate(rho_xc.reshape(-1))
            e, v_up = out["e"], out["v"]
    # K17b: exc, V_xc (and B_z) as float64 and as the complex boxes the
    # forward FFT takes
    exc_r, vxc_r, vxc_box, bz_box = xc_outputs(e, v_up, rho_xc, v_dn, div)
    del div

    vxc_g = box_to_g(vxc_box, tables.fft_index, dims)
    bz_g = box_to_g(bz_box, tables.fft_index, dims) if polarized else None
    # K17c (i): V_H and V_loc + V_H + V_xc in one pass
    vha_g, veff_g = hartree_veff(rho_g, tables.glen2, tables.vloc_g, vxc_g)
    if tables.sym is not None:
        veff_g = symmetrize_pw(tables.sym, veff_g)
        if polarized:
            bz_g = symmetrize_pw(tables.sym, bz_g, axial_z=True)

    # mGGA: v_tau per spin, smoothed through the coarse G set for the
    # -1/2 div(v_tau grad) operator, and the int v_tau tau integral that the
    # eval_sum double-counting correction needs (potential.py:189-205)
    fields = [veff_g] + ([bz_g] if polarized else [])
    vtau_pairs = []
    if vtau is not None:
        fields += [r_to_g(v.view(dims), tables.fft_index, dims) for v in vtau]
        vtau_pairs = [(tau_r[s], vtau[s].view(dims))
                      for s in range(vtau.shape[0])]
    # K17d: every field's coarse box in one pass, each transformed alone,
    # then the per-spin potential (and v_tau) from the transformed boxes
    boxes = [torch.fft.ifftn(b.view(tables.dims_coarse), dim=(-3, -2, -1),
                             norm="forward")
             for b in coarse_fill(fields, tables.coarse_box_to_fine)]
    nsp = 2 if polarized else 1
    veff_r_coarse = coarse_stack(boxes[:nsp], polarized)
    vtau_r_coarse = (coarse_stack(boxes[nsp:], False) if vtau is not None
                     else None)

    integrands = {
        "vha": [(rho_r, to_r(vha_g))],
        "vxc": [(rho_r, vxc_r)],
        "vloc": [(rho_r, tables.vloc_r)],
        "veff": [(rho_r, to_r(veff_g))],
        "exc": [(inp.rho_exc, exc_r)],
        "bxc": [(inp.mag_r, to_r(bz_g))] if polarized else [],
        "vtau_tau": vtau_pairs,
    }
    return PotentialResult(
        veff_g=veff_g,
        bz_g=bz_g,
        veff_r_coarse=veff_r_coarse,
        vha_g=vha_g,
        vxc_g=vxc_g,
        integrands=integrands,
        omega=tables.omega,
        vtau_r_coarse=vtau_r_coarse,
    )
