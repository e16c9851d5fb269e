"""K-set-batched spinor band solve and four-component density
(non-collinear magnetism).

Mirrors sirius_tpu/parallel/batched_nc.py. Spinors are flattened into the
G axis ([nb, 2 ngk]) so the batched Davidson runs unchanged, with the whole
k-set as its batch axis. The density is the reference's four real fields
(rho, m_z, m_x, m_y) (density.cpp:636-700: up = |psi_u|^2, dn = |psi_d|^2,
m_x = 2 Re psi_u psi_d*, m_y = -2 Im), accumulated k-point by k-point by
K1's scatter, cuFFT and K12b. The JAX package's (re, im) split of the
complex leaves is not ported: the tensors stay complex, complex128 or, on
the fp32 wave-function path, complex64 with float32 tables (the density and
the density matrix still sum in float64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.kernels.density_accumulate_nc import density_accumulate_nc
from sirius_tpu_torch.kernels.local_hpsi import pw_to_box
from sirius_tpu_torch.ops.hamiltonian import astype
from sirius_tpu_torch.ops.spinor import NcHkParams, apply_h_s_nc
from sirius_tpu_torch.parallel.batched import compute_h_diag, compute_o_diag
from sirius_tpu_torch.solvers.davidson import davidson


@dataclasses.dataclass
class NcSetParams(NcHkParams):
    """Batched-over-k spinor Hamiltonian data (the k-set is the operator's
    batch axis) and the band solve's preconditioner diagonals."""

    h_diag: torch.Tensor  # [nk, 2 ngk]
    o_diag: torch.Tensor  # [nk, 2 ngk]


def nc_h_diag(ekin, mask, beta, dmat, v0):
    """h_diag [nk, 2 ngk] of the flattened spinor solve: the collinear
    diagonal (compute_h_diag) of the uu block for the up half and of the dd
    block for the down half, from the real part of the blocks as the JAX
    package takes it (batched_nc.py:84)."""
    h = compute_h_diag(ekin, mask, beta, dmat[:2].real, v0)
    return h.reshape(h.shape[0], -1)


def make_nc_set_params(ctx, veff_boxes, dmat_blocks, qmat_blocks=None,
                       v0=0.0, prev: NcSetParams | None = None,
                       device=None, dtype=torch.complex128) -> NcSetParams:
    """veff_boxes [4, n1, n2, n3] (v_uu, v_dd, bx, by) coarse real boxes;
    dmat_blocks [4, nbeta, nbeta] complex (uu, dd, ud, du); qmat_blocks
    defaults to the spin-diagonal augmentation Q; v0 the average potential
    veff(G=0). Tensors or host arrays in, tensors on ``device`` out (None:
    the GPU, raising without CUDA) at the working dtype: complex64 gives
    the fp32 set (the JAX package's make_nc_set_params(dtype=)), its h_diag
    computed in float64 and then cast.

    prev: the previous iteration's params of the same dtype, whose constant
    tables (projectors, kinetic energies, masks, Q, o_diag) are reused;
    only the potential's leaves are replaced (an fp32 prev gives h_diag
    from its float32 tables, summed in float64)."""
    device = resolve_device(device)
    if dtype != torch.complex128 and (prev is None or prev.beta.dtype
                                      != dtype):
        return astype(make_nc_set_params(ctx, veff_boxes, dmat_blocks,
                                         qmat_blocks, v0, None, device),
                      dtype)
    veff = torch.as_tensor(veff_boxes, dtype=torch.float64,
                           device=device).contiguous()
    dmat = torch.as_tensor(dmat_blocks, dtype=torch.complex128, device=device)
    if prev is not None and prev.beta.dtype == dtype:
        return astype(dataclasses.replace(
            prev, veff=veff, dmat=dmat,
            h_diag=nc_h_diag(prev.ekin.double(), prev.mask.double(),
                             prev.beta.to(torch.complex128), dmat, v0)),
            dtype)
    nbeta = ctx.beta.num_beta_total
    nk = ctx.gkvec.num_kpoints
    if qmat_blocks is None:
        q = (ctx.beta.qmat if ctx.beta.qmat is not None
             else np.zeros((nbeta, nbeta)))
        z = np.zeros_like(q)
        qmat_blocks = np.stack([q, q, z, z]).astype(np.complex128)
    beta = (np.asarray(ctx.beta.beta_gk) if nbeta
            else np.zeros((nk, 0, ctx.gkvec.ngk_max), dtype=np.complex128))

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ekin = t(ctx.gkvec.kinetic(), torch.float64)
    mask = t(ctx.gkvec.mask, torch.float64)
    beta_t = t(beta, torch.complex128) * mask[:, None, :]
    o_diag = t(compute_o_diag(ctx), torch.float64)
    return NcSetParams(
        veff=veff, ekin=ekin, mask=mask,
        fft_index=t(ctx.gkvec.fft_index, torch.int32), beta=beta_t,
        dmat=dmat, qmat=t(qmat_blocks, torch.complex128),
        h_diag=nc_h_diag(ekin, mask, beta_t, dmat, v0),
        o_diag=torch.cat([o_diag, o_diag], dim=1))


def davidson_kset_nc(params: NcSetParams, psi, num_steps: int = 20,
                     res_tol: float = 1e-6):
    """psi [nk, nb, 2 ngk] flattened spinors -> (evals [nk, nb], psi',
    rnorm [nk, nb]), one batched solve over the k-set with mask2 = the
    k-point's mask tiled over both spin halves; at the working type of psi
    and params."""
    mask2 = params.mask.repeat(1, 2)
    return davidson(apply_h_s_nc, params, psi, params.h_diag,
                    params.o_diag, mask2, num_steps=num_steps,
                    res_tol=res_tol)


def density_kset_nc(params: NcSetParams, psi, occ_w):
    """Four-component coarse-box density (rho, m_z, m_x, m_y), accumulated
    k-point by k-point in k order (K1 scatter, cuFFT, K12b).

    psi [nk, nb, 2 ngk] complex128, or complex64 with the fp32 params;
    occ_w [nk, nb] occupation x k-weight. Returns [4, n1, n2, n3]
    float64."""
    nk, nb, ngk2 = psi.shape
    ngk = ngk2 // 2
    dims = tuple(params.veff.shape[-3:])
    n = dims[0] * dims[1] * dims[2]
    acc = torch.zeros((4, n), dtype=torch.float64, device=psi.device)
    for ik in range(nk):
        box = pw_to_box(psi[ik].reshape(1, 2 * nb, ngk), params.fft_index[ik],
                        params.mask[ik], n)
        fr = torch.fft.ifftn(box.view((2 * nb,) + dims), dim=(-3, -2, -1))
        del box
        density_accumulate_nc(acc, fr.view(nb, 2, n), occ_w[ik],
                              float(n) ** 2)
    return acc.view((4,) + dims)


def density_matrix_kset_nc(beta, psi, occ_w):
    """Spin-resolved non-local density matrix, 3 components (uu, dd, ud):
    n^{ss'}_{xy} = sum_{k,b} occ_w <beta_x|psi_s> conj(<beta_y|psi_s'>)
    (reference density.cpp:901-1025; the du block is the Hermitian conjugate
    and not stored). Batched matrix products.

    beta [nk, nbeta, ngk] complex128 (zero on padded lanes), psi
    [nk, nb, 2 ngk], occ_w [nk, nb]. Returns [3, nbeta, nbeta] complex128;
    complex64 bands are promoted to complex128 first, as the JAX package
    promotes them (batched_nc.py:166-168)."""
    psi = psi.to(torch.promote_types(psi.dtype, beta.dtype))
    nk, nb, ngk2 = psi.shape
    p = psi.reshape(nk, nb, 2, ngk2 // 2).transpose(1, 2)  # [nk, 2, nb, ngk]
    bp = torch.matmul(p, beta.mH[:, None])  # [nk, 2, nb, nbeta]
    bw = bp * occ_w[:, None, :, None].to(bp.dtype)
    uu = torch.matmul(bw[:, 0].mT, bp[:, 0].conj()).sum(dim=0)
    dd = torch.matmul(bw[:, 1].mT, bp[:, 1].conj()).sum(dim=0)
    ud = torch.matmul(bw[:, 0].mT, bp[:, 1].conj()).sum(dim=0)
    return torch.stack([uu, dd, ud])
