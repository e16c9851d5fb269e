"""K-set-batched band solve: the whole (k, spin) set as one batch.

Mirrors sirius_tpu/parallel/batched.py. The JAX package vmaps the per-k
solve and splits complex leaves into (re, im) pairs for its TPU backend;
here the k-set is an explicit leading batch axis and the tensors stay
complex end to end: complex128, or complex64 with float32 tables on the
fp32 wave-function path (precision_wf = "fp32"), where the density and the
density matrix still sum in float64, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.kernels.density_accumulate import density_accumulate
from sirius_tpu_torch.kernels.local_hpsi import pw_to_box
from sirius_tpu_torch.ops.hamiltonian import HkParams, apply_h_s, astype
from sirius_tpu_torch.solvers.davidson import davidson, subspace_rotate


@dataclasses.dataclass
class HkSetParams:
    """Batched-over-(k, spin) Hamiltonian data (the JAX leaves, complex).
    The types below are the fp64 ones; astype(params, complex64) gives the
    fp32 set (float32 real tables, complex64 complex ones)."""

    veff_r: torch.Tensor  # [ns, n1, n2, n3] effective potential per spin
    ekin: torch.Tensor  # [nk, ngk]
    mask: torch.Tensor  # [nk, ngk]
    fft_index: torch.Tensor  # [nk, ngk] int32
    beta: torch.Tensor  # [nk, nbeta, ngk] complex128, zero on padded lanes
    dion: torch.Tensor  # [ns, nbeta, nbeta] complex128 screened D per spin
    # [nbeta, nbeta] complex128 S-operator integrals; None where Q is all
    # zero (norm-conserving species)
    qmat: torch.Tensor | None
    h_diag: torch.Tensor  # [nk, ns, ngk]
    o_diag: torch.Tensor  # [nk, ngk]

    @property
    def num_spins(self) -> int:
        return self.veff_r.shape[0]

    def hk(self) -> HkParams:
        """The flattened batch (B = nk * ns) that apply_h_s takes: batch
        entry b = ik * ns + ispn reads the k tables of ik (shared by the
        spins) and dion[ispn]. Unpolarized these are views of the leaves;
        polarized the k tables are repeated per spin."""
        ns = self.num_spins
        nk = self.ekin.shape[0]
        if ns == 1:
            return HkParams(veff_r=self.veff_r, ekin=self.ekin,
                            mask=self.mask, fft_index=self.fft_index,
                            beta=self.beta,
                            dion=self.dion.expand(nk, -1, -1),
                            qmat=self.qmat)

        def per_spin(t):
            return t.repeat_interleave(ns, dim=0)

        return HkParams(veff_r=self.veff_r, ekin=per_spin(self.ekin),
                        mask=per_spin(self.mask),
                        fft_index=per_spin(self.fft_index),
                        beta=per_spin(self.beta),
                        dion=self.dion.repeat(nk, 1, 1), qmat=self.qmat)


def compute_h_diag(ekin, mask, beta, dion, v0):
    """h_diag [nk, ns, ngk]: H preconditioner diagonal for the whole k-set
    (reference get_h_o_diag_pw); changes every SCF iteration with v0 and
    the screened D. ekin/mask [nk, ngk], beta [nk, nbeta, ngk] complex,
    dion [ns, nbeta, nbeta], v0 the average effective potential veff(G=0)
    (a float or a 0-d tensor)."""
    h = ekin[:, None, :] + v0
    if beta.shape[1]:
        h = h + torch.einsum("kxg,sxy,kyg->ksg", beta.conj(),
                             dion.to(beta.dtype), beta).real
    else:
        h = h.expand(h.shape[0], dion.shape[0], h.shape[2])
    return torch.where(mask[:, None, :] > 0, h, 1e4)


def compute_o_diag(ctx):
    """o_diag [nk, ngk]: S preconditioner diagonal; potential-independent
    (only the constant augmentation Q enters), computed once per run."""
    nbeta = ctx.beta.num_beta_total
    nk = ctx.gkvec.num_kpoints
    qmat = ctx.beta.qmat if ctx.beta.qmat is not None else np.zeros((nbeta, nbeta))
    o_diag = np.empty((nk, ctx.gkvec.ngk_max))
    for ik in range(nk):
        o = np.ones(ctx.gkvec.ngk_max)
        if nbeta:
            b = ctx.beta.beta_gk[ik]
            o = o + np.real(np.einsum("xg,xy,yg->g", np.conj(b), qmat, b))
        o_diag[ik] = np.where(ctx.gkvec.mask[ik] > 0, o, 1.0)
    return o_diag


def make_hkset_params(ctx, veff_r_coarse, d_full=None, v0: float = 0.0,
                      device=None, dtype=torch.complex128) -> HkSetParams:
    """veff_r_coarse: [n1,n2,n3] or [ns, n1,n2,n3]; d_full: [nbeta,nbeta] or
    [ns,nbeta,nbeta] screened D (defaults to the bare dion); v0: average
    effective potential veff(G=0), included in the preconditioner diagonal.
    Host numpy in, tensors on ``device`` out (None: the GPU, raising
    without CUDA) at the working dtype (complex64: the fp32 tables, as the
    JAX package's make_hkset_params(dtype=))."""
    nbeta = ctx.beta.num_beta_total
    nk = ctx.gkvec.num_kpoints
    veff = np.asarray(veff_r_coarse, dtype=np.float64)
    if veff.ndim == 3:
        veff = veff[None]
    ns = veff.shape[0]
    dion = ctx.beta.dion if d_full is None else np.asarray(d_full)
    if dion.ndim == 2:
        dion = np.broadcast_to(dion, (ns,) + dion.shape)
    qmat = ctx.beta.qmat if ctx.beta.qmat is not None else np.zeros((nbeta, nbeta))
    beta = (np.asarray(ctx.beta.beta_gk) if nbeta
            else np.zeros((nk, 0, ctx.gkvec.ngk_max), dtype=np.complex128))
    return hkset_from_arrays(dict(
        veff_r=veff, ekin=ctx.gkvec.kinetic(), mask=ctx.gkvec.mask,
        fft_index=ctx.gkvec.fft_index, beta=beta, dion=dion, qmat=qmat,
        o_diag=compute_o_diag(ctx),
    ), device, v0=v0, dtype=dtype)


def hkset_from_arrays(a: dict, device, v0: float = 0.0,
                      dtype=torch.complex128) -> HkSetParams:
    """HkSetParams from host arrays (complex ``beta``) at the working dtype
    (complex128, or complex64 for the fp32 tables). The projectors are
    masked and D and Q made complex here, once (Q becomes None where it is
    all zero); ``h_diag``, where ``a`` holds none, is computed on the device
    by compute_h_diag with v0, in float64 before the cast, as the JAX
    package computes it on the host."""
    device = resolve_device(device)

    # the kernels trust fft_index: check it against the box once, here
    nbox = int(np.prod(np.shape(a["veff_r"])[-3:]))
    fidx = np.asarray(a["fft_index"])
    if fidx.size and (fidx.min() < 0 or fidx.max() >= nbox):
        raise ValueError(f"fft_index outside the {nbox}-point box")

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    f64, c128 = torch.float64, torch.complex128
    ekin, mask = t(a["ekin"], f64), t(a["mask"], f64)
    beta = t(a["beta"], c128) * mask[:, None, :]
    dion = t(a["dion"], c128)
    h_diag = (t(a["h_diag"], f64) if "h_diag" in a
              else compute_h_diag(ekin, mask, beta, dion, v0))
    return astype(HkSetParams(
        veff_r=t(a["veff_r"], f64), ekin=ekin, mask=mask,
        fft_index=t(a["fft_index"], torch.int32), beta=beta, dion=dion,
        qmat=(t(a["qmat"], c128) if np.any(np.asarray(a["qmat"]) != 0)
              else None),
        h_diag=h_diag, o_diag=t(a["o_diag"], f64)), dtype)


def initialize_subspace_kset(params: HkSetParams, psi, nb: int):
    """LCAO subspace initialization for the whole (k, spin) set: one H/S
    application to the full atomic-orbital block [nk, ns, nbig, ngk]
    (nbig >= nb), one generalized Rayleigh-Ritz, keep the lowest nb Ritz
    vectors. Returns [nk, ns, nb, ngk]."""
    nk, ns, nbig, ngk = psi.shape
    hk = params.hk()
    x = psi.reshape(nk * ns, nbig, ngk) * hk.mask[:, None, :]
    hx, sx = apply_h_s(hk, x)
    out = subspace_rotate(x, hx, sx, nb, mask=hk.mask)
    return out.reshape(nk, ns, nb, ngk)


def davidson_kset(params: HkSetParams, psi, num_steps: int = 20,
                  res_tol: float = 1e-6):
    """Solve bands at every (k, spin) in one batched call.

    psi: [nk, ns, nb, ngk] -> (evals [nk, ns, nb], psi', rnorm [nk, ns, nb]),
    all at the working type of psi and params (evals float32 at fp32)."""
    nk, ns, nb, ngk = psi.shape
    hk = params.hk()
    ev, x, rn = davidson(
        apply_h_s, hk, psi.reshape(nk * ns, nb, ngk),
        params.h_diag.reshape(nk * ns, ngk),
        params.o_diag.repeat_interleave(ns, dim=0), hk.mask,
        num_steps=num_steps, res_tol=res_tol)
    return (ev.reshape(nk, ns, nb), x.reshape(nk, ns, nb, ngk),
            rn.reshape(nk, ns, nb))


def density_kset(params: HkSetParams, psi, occ_w):
    """Coarse-box density sum_{k,b} occ_w |psi(r)|^2 per spin, accumulated
    k-point by k-point in k order (K1 scatter, cuFFT, K3).

    psi [nk, ns, nb, ngk] complex128, or complex64 with the fp32 params
    (K1 and K3 then run their complex64 instantiations; the sum stays
    float64); occ_w [nk, ns, nb] occupation x k-weight float64.
    Returns [ns, n1, n2, n3] float64."""
    nk, ns, nb, ngk = psi.shape
    dims = tuple(params.veff_r.shape[-3:])
    n = dims[0] * dims[1] * dims[2]
    acc = torch.zeros((ns, n), dtype=torch.float64, device=psi.device)
    for ik in range(nk):
        box = pw_to_box(psi[ik], params.fft_index[ik], params.mask[ik], n)
        fr = torch.fft.ifftn(box.view((ns, nb) + dims), dim=(-3, -2, -1))
        del box
        density_accumulate(acc, fr.view(ns, nb, n), occ_w[ik], float(n) ** 2)
    return acc.view((ns,) + dims)


def density_matrix_kset(beta, psi, occ_w):
    """Non-local density matrix n^s_{xi xi'} = sum_{k,b} occ_w
    conj(<beta_xi|psi>) <beta_xi'|psi> over the whole k-set (reference
    add_k_point_contribution_dm_pwpp, density.cpp:847-901; the JAX package's
    density_matrix_kset, batched.py:346-367). Two batched matrix products.

    beta [nk, nbeta, ngk] complex128 (zero on padded lanes), psi
    [nk, ns, nb, ngk], occ_w [nk, ns, nb] occupation x k-weight. Returns
    [ns, nbeta, nbeta] complex128. complex64 bands are promoted to complex128
    before the products, so the sum is fp64 whatever the working precision
    (the JAX package's density_matrix_kset, batched.py:358-360)."""
    psi = psi.to(torch.promote_types(psi.dtype, beta.dtype))
    bp = torch.matmul(psi, beta.mH[:, None])  # [nk, ns, nb, nbeta]
    dm = torch.matmul((bp.conj() * occ_w[..., None].to(bp.dtype)).mT, bp)
    return dm.sum(dim=0)
