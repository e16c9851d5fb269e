"""Spinor (non-collinear) Hamiltonian application.

Mirrors sirius_tpu/ops/spinor.py. The 2x2 spin-block Hamiltonian
(reference local_operator.cpp:380-460, non_local_operator.cpp:110-259)

  H_uu = T + V + Bz      H_ud = Bx - i By
  H_du = Bx + i By       H_dd = T + V - Bz

plus the non-local sum_s' |beta> D^{ss'} <beta|psi_s'> with the four blocks
(uu, dd, ud, du) of D and Q. A spinor band block is flattened to
[B, nb, 2 ngk] (the up then the down coefficients), so the batched Davidson
(solvers/davidson.py) runs on it unchanged. apply_h_s_nc views the block as
[B, 2 nb, ngk] rows that share one fft_index, scatters them with K1, runs
one batched cuFFT, applies the 2x2 potential in real space (K12a), transforms
back and gathers with the kinetic term (K1); the non-local blocks are
batched matrix products. The JAX package applies H at one k-point and
vmaps; here every table carries the k batch axis B.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class NcHkParams:
    """Everything needed to apply spinor H and S to a batch of B k-points.

    Spin-block order of dmat and qmat: [uu, dd, ud, du]."""

    veff: torch.Tensor  # [4, n1, n2, n3] float64: V + Bz, V - Bz, Bx, By
    ekin: torch.Tensor  # [B, ngk] float64
    mask: torch.Tensor  # [B, ngk] float64
    fft_index: torch.Tensor  # [B, ngk] int32
    beta: torch.Tensor  # [B, nbeta, ngk] complex128, zero on padded lanes
    dmat: torch.Tensor  # [4, nbeta, nbeta] complex128 spin blocks
    qmat: torch.Tensor  # [4, nbeta, nbeta] complex128 spin blocks

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.veff.shape[-3:])


def _block_matrix(m):
    """The [2 nbeta, 2 nbeta] matrix that takes the row of projections
    [<beta|psi_u>, <beta|psi_d>] to the coefficients [c_u, c_d] of the
    projectors: c_u = bp_u uu^T + bp_d ud^T, c_d = bp_u du^T + bp_d dd^T
    (ops/spinor.py:79-96, the einsums with d[k].T)."""
    return torch.cat([torch.cat([m[0].mT, m[3].mT], dim=1),
                      torch.cat([m[2].mT, m[1].mT], dim=1)], dim=0)


def apply_h_s_nc(params: NcHkParams, psi: torch.Tensor):
    """(H psi, S psi) for flattened spinor blocks psi [B, R, 2 ngk]."""
    from sirius_tpu_torch.kernels.local_hpsi import box_to_pw_hpsi, pw_to_box
    from sirius_tpu_torch.kernels.spinor_veff import spinor_veff

    apply_h_s_nc.calls += 1
    b, r, ngk2 = psi.shape
    ngk = ngk2 // 2
    dims = params.dims
    n = dims[0] * dims[1] * dims[2]
    rows = psi.reshape(b, 2 * r, ngk)
    # one batched scatter-FFT over (band, spin)
    box = pw_to_box(rows, params.fft_index, params.mask, n)
    fr = torch.fft.ifftn(box.view((b, 2 * r) + dims), dim=(-3, -2, -1))
    del box
    v = params.veff.view(4, n)
    spinor_veff(fr.view(b * r, 2, n), v[0], v[1], v[2], v[3])
    vbox = torch.fft.fftn(fr, dim=(-3, -2, -1)).view(b, 2 * r, n)
    del fr
    hpsi, spsi = box_to_pw_hpsi(vbox, rows, params.ekin, params.mask,
                                params.fft_index)
    del vbox
    nbeta = params.beta.shape[1]
    if nbeta:
        # bp[b, (band, s), x] = <beta_x|psi_s>; spsi is the masked psi
        bp = torch.matmul(spsi, params.beta.mH).view(b, r, 2 * nbeta)
        coef = torch.matmul(bp, _block_matrix(params.dmat))
        hpsi = torch.baddbmm(hpsi, coef.view(b, 2 * r, nbeta), params.beta)
        coef = torch.matmul(bp, _block_matrix(params.qmat))
        spsi = torch.baddbmm(spsi, coef.view(b, 2 * r, nbeta), params.beta)
    return hpsi.view(b, r, ngk2), spsi.view(b, r, ngk2)


apply_h_s_nc.calls = 0


def spin_blocks_from_components(d0, dz, dx, dy):
    """The (uu, dd, ud, du) blocks [4, nbeta, nbeta] complex128 from the
    per-component integrals D(V), D(Bz), D(Bx), D(By), real [nbeta, nbeta]
    tensors (the JAX package's host function of the name, :101-114;
    reference non_local_operator.cpp:230-258, the no-spin-orbit branch).
    The preconditioner diagonals of the spinor solve, the JAX package's
    nc_h_o_diag (:117-142), are parallel/batched_nc.py::nc_h_diag and
    make_nc_set_params."""
    return torch.stack([torch.complex(d0 + dz, torch.zeros_like(d0)),
                        torch.complex(d0 - dz, torch.zeros_like(d0)),
                        torch.complex(dx, -dy), torch.complex(dx, dy)])
