"""Non-collinear effective potential: XC in the locally diagonal spin frame.

Mirrors sirius_tpu/dft/potential_nc.py on device tensors (reference
xc.cpp:229-404 xc_rg_magnetic). The collinear XC functional is evaluated on
the projected densities n_up/dn = (rho_xc +- min(|m|, rho_xc))/2 (K7 / K7b
for LDA; K10a, cuFFT, K7g, cuFFT, K10b for GGA, with the gradients of the
projected channel densities), and B_xc = (v_up - v_dn)/2 points along the
local magnetization direction m-hat. Hartree, the local potential and the
scalar symmetrization (K6) are those of dft/potential.py; the magnetic
field is symmetrized as an axial vector, m'_i(g') = det(R) R_ij m_j(g)
(K6v). Vector components are stored (x, y, z). V_H and the V_eff sum are
K17c (i), and the coarse boxes of V and B are K17d's fill; the other
pointwise passes here (the |m| projection, B along m-hat, the four-box
stack) are host numpy in the JAX package
(sirius_tpu/dft/potential_nc.py:78-160), no XLA fusion, and stay PyTorch
ops.
"""

from __future__ import annotations

import dataclasses

import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
from sirius_tpu_torch.dft.density import GridTables, SymPwTables, symmetrize_pw
from sirius_tpu_torch.dft.potential import _inner_rr, divergence_g, gradient_r
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels.coarse_potential import coarse_fill
from sirius_tpu_torch.kernels.hartree_veff import hartree_veff
from sirius_tpu_torch.kernels.symmetrize_pw import (
    symmetrize_vector_pw as symmetrize_vector_kernel,
)


@dataclasses.dataclass
class NcPotentialResult:
    veff_g: torch.Tensor  # fine G: charge part (V_loc + V_H + V_xc)
    bvec_g: torch.Tensor  # [3, ng] fine G: (Bx, By, Bz)
    veff_boxes: torch.Tensor  # [4, coarse box]: V + Bz, V - Bz, Bx, By
    vha_g: torch.Tensor
    vxc_g: torch.Tensor
    energies: dict  # python floats, reference names


def symmetrize_vector_pw(tb: SymPwTables, mvec_g: torch.Tensor) -> torch.Tensor:
    """Axial-vector PW symmetrization over the magnetic space group (K6v):
    m'_i(g') = (1/N) sum_S det(R) R_ij m_j(w_k^{-1} g') e^{-2 pi i g'.t}.
    mvec_g [3, ng] complex128 (x, y, z)."""
    return symmetrize_vector_kernel(mvec_g.contiguous(), tb.millers, tb.lut,
                                    tb.rot, tb.trans, tb.srot, tb.dims,
                                    tb.cosets)


def generate_potential_nc(
    ctx: SimulationContext,
    rho_g: torch.Tensor,
    xc: XCFunctional,
    mvec_g: torch.Tensor,
    tables: GridTables,
) -> NcPotentialResult:
    """rho_g [ng] and mvec_g [3, ng] (mx, my, mz) complex128 on the device
    of ``tables``."""
    dims = tables.dims
    npt = dims[0] * dims[1] * dims[2]

    def to_r(f_g):
        return g_to_r(f_g, tables.fft_index, dims).real

    rho_r = to_r(rho_g)
    rho_core_r = tables.rho_core_r
    m_r = to_r(mvec_g)  # [3, box]
    m_len = torch.sqrt(torch.sum(m_r ** 2, dim=0))

    rho_xc = torch.clamp(rho_r + rho_core_r, min=1e-20)
    ml = torch.minimum(m_len, rho_xc)
    n_up = 0.5 * (rho_xc + ml)
    n_dn = 0.5 * (rho_xc - ml)
    if xc.is_gga:
        # gradients of the projected channel densities (the reference takes
        # them AFTER the |m| projection, xc.cpp:415-426)
        g = gradient_r(tables, r_to_g(torch.stack([n_up, n_dn]),
                                      tables.fft_index, dims))
        e, v_up, v_dn, fu, fd = xc.evaluate_gga_polarized(
            n_up.reshape(-1), n_dn.reshape(-1), g[0].view(3, npt),
            g[1].view(3, npt))
        del g
        # v_s -= div(2 vsigma_ss grad n_s + vsigma_ud grad n_s')
        div = to_r(divergence_g(tables, torch.stack([fu, fd]).view(
            (2, 3) + dims)))
        del fu, fd
        v_up = v_up.view(dims) - div[0]
        v_dn = v_dn.view(dims) - div[1]
    else:
        out = xc.evaluate_polarized(n_up.reshape(-1), n_dn.reshape(-1))
        e, v_up, v_dn = out["e"], out["v_up"].view(dims), out["v_dn"].view(dims)
    e_r = e.view(dims)
    vxc_r = 0.5 * (v_up + v_dn)
    bxc = 0.5 * (v_up - v_dn)
    # B along m-hat (xc.cpp:386-400; its sign guard is the identity here,
    # n_up - n_dn = min(|m|, rho_xc) >= 0), zero where |m| <= 1e-8
    mhat = torch.where(m_len[None] > 1e-8,
                       m_r / torch.clamp(m_len, min=1e-30)[None], 0.0)
    b_r = bxc[None] * mhat

    exc_r = e_r / torch.clamp(rho_xc, min=1e-25)
    vxc_g = r_to_g(vxc_r, tables.fft_index, dims)
    # K17c (i): V_H and V_loc + V_H + V_xc in one pass
    vha_g, veff_g = hartree_veff(rho_g, tables.glen2, tables.vloc_g, vxc_g)
    bvec_g = r_to_g(b_r, tables.fft_index, dims)
    if tables.sym is not None:
        veff_g = symmetrize_pw(tables.sym, veff_g)
        bvec_g = symmetrize_vector_pw(tables.sym, bvec_g)

    # K17d fill: V and B's three components into their coarse boxes in one
    # pass; V transformed alone, B as one batch of three
    boxes = coarse_fill([veff_g, *bvec_g], tables.coarse_box_to_fine).view(
        (4,) + tables.dims_coarse)
    v_c = torch.fft.ifftn(boxes[0], dim=(-3, -2, -1), norm="forward").real
    b_c = torch.fft.ifftn(boxes[1:], dim=(-3, -2, -1), norm="forward").real
    veff_boxes = torch.stack([v_c + b_c[2], v_c - b_c[2], b_c[0], b_c[1]])

    om = tables.omega
    b_r_sym = to_r(bvec_g)
    energies = {
        "vha": _inner_rr(om, rho_r, to_r(vha_g)),
        "vxc": _inner_rr(om, rho_r, vxc_r),
        "vloc": _inner_rr(om, rho_r, tables.vloc_r),
        "veff": _inner_rr(om, rho_r, to_r(veff_g)),
        "exc": _inner_rr(om, rho_r + rho_core_r, exc_r),
        # the magnetization before symmetrization, as the JAX package
        # takes it (potential_nc.py:156)
        "bxc": sum(_inner_rr(om, m_r[i], b_r_sym[i]) for i in range(3)),
    }
    # python floats, in one readback
    energies = dict(zip(energies, torch.stack(list(energies.values()))
                        .tolist()))
    return NcPotentialResult(veff_g=veff_g, bvec_g=bvec_g,
                             veff_boxes=veff_boxes.contiguous(), vha_g=vha_g,
                             vxc_g=vxc_g, energies=energies)
