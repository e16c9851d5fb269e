"""Hamiltonian application H*psi, S*psi over a batch of (k, spin) blocks.

Mirrors sirius_tpu/ops/hamiltonian.py. The JAX package applies H at one
k-point and vmaps over the k-set; here every per-k table carries an explicit
leading batch axis B and one call applies H to the whole set. The local part
is K1 (kernels/local_hpsi.py) around two batched cuFFT transforms; the
nonlocal beta terms are batched matrix products.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device


def real_dtype_of(dtype) -> torch.dtype:
    """The real type paired with a working type: float32 for complex64 or
    float32 (the fp32 wave-function path), float64 otherwise (the JAX
    package's real_dtype_of, ops/hamiltonian.py:17-21)."""
    return (torch.float32 if dtype in (torch.complex64, torch.float32)
            else torch.float64)


def complex_dtype_of(dtype) -> torch.dtype:
    """The complex type paired with a working type."""
    return (torch.complex64 if real_dtype_of(dtype) == torch.float32
            else torch.complex128)


def astype(params, dtype):
    """A parameter dataclass at a working type (complex64 or float32 for
    fp32, complex128 or float64 for fp64): every floating tensor field cast
    to real_dtype_of(dtype), every complex one to complex_dtype_of(dtype).
    Integer tensors, other fields and tensors already of the type are
    shared with params, not copied."""
    rdt, cdt = real_dtype_of(dtype), complex_dtype_of(dtype)
    changes = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor):
            if v.is_complex():
                changes[f.name] = v.to(cdt)
            elif v.is_floating_point():
                changes[f.name] = v.to(rdt)
    return dataclasses.replace(params, **changes)


@dataclasses.dataclass
class HkParams:
    """Everything needed to apply H and S to a batch of B blocks.

    veff_r is per spin channel [ns, n1, n2, n3] and broadcasts over the
    k-points: batch entry b = ik * ns + ispn uses veff_r[ispn]. The types
    below are the fp64 ones; at fp32 (astype(params, complex64)) the real
    tables are float32 and the complex ones complex64.
    """

    veff_r: torch.Tensor  # [ns, n1, n2, n3] float64, coarse box
    ekin: torch.Tensor  # [B, ngk] float64
    mask: torch.Tensor  # [B, ngk] float64, 1 valid / 0 padding
    fft_index: torch.Tensor  # [B, ngk] int32
    beta: torch.Tensor  # [B, nbeta, ngk] complex128, zero on padded lanes
    dion: torch.Tensor  # [B, nbeta, nbeta] complex128 (real values)
    # [nbeta, nbeta] complex128 S-operator integrals q_mtrx (ultrasoft);
    # None for norm-conserving species, where S = 1
    qmat: torch.Tensor | None = None

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.veff_r.shape[-3:])


def make_hk_params(ctx, ik: int, veff_r_coarse, dmat=None, device=None,
                   dtype=torch.complex128) -> HkParams:
    """One k-point as a batch of one (D is the bare D_ion unless dmat is
    given; Q is the context's q_mtrx, None without augmentation).
    veff_r_coarse: [n1, n2, n3] or [1, n1, n2, n3]. device=None is the GPU
    and raises without CUDA; dtype complex64 gives the fp32 tables (the JAX
    package's make_hk_params(dtype=))."""
    device = resolve_device(device)
    nbeta = ctx.beta.num_beta_total
    mask = np.asarray(ctx.gkvec.mask[ik:ik + 1])
    beta = (ctx.beta.beta_gk[ik:ik + 1] if nbeta
            else np.zeros((1, 0, ctx.gkvec.ngk_max), dtype=np.complex128))
    d = ctx.beta.dion if dmat is None else np.asarray(dmat)
    veff = np.asarray(veff_r_coarse, dtype=np.float64)
    return astype(HkParams(
        veff_r=torch.tensor(veff.reshape((1,) + veff.shape[-3:]),
                               device=device),
        ekin=torch.tensor(ctx.gkvec.kinetic()[ik:ik + 1], device=device),
        mask=torch.tensor(mask, device=device),
        fft_index=torch.tensor(ctx.gkvec.fft_index[ik:ik + 1],
                                  device=device),
        beta=torch.tensor(beta * mask[:, None, :], device=device),
        dion=torch.tensor(np.asarray(d, dtype=np.complex128)[None],
                             device=device),
        qmat=(None if ctx.beta.qmat is None else torch.tensor(
            np.asarray(ctx.beta.qmat, dtype=np.complex128), device=device)),
    ), dtype)


def apply_h_s(params: HkParams, psi: torch.Tensor):
    """(H psi, S psi) for a block psi [B, R, ngk]; S = 1 + beta Q beta^+
    (S = 1 for norm-conserving species, qmat None). psi complex128 with the
    fp64 tables, or complex64 with the fp32 ones (every kernel then runs its
    complex64 instantiation)."""
    from sirius_tpu_torch.kernels.local_hpsi import box_to_pw_hpsi, pw_to_box
    from sirius_tpu_torch.kernels.veff_multiply import veff_multiply

    b, r, ngk = psi.shape
    dims = params.dims
    n = dims[0] * dims[1] * dims[2]
    ns = params.veff_r.shape[0]
    box = pw_to_box(psi, params.fft_index, params.mask, n)
    fr = torch.fft.ifftn(box.view((b, r) + dims), dim=(-3, -2, -1))
    del box
    # V(r) psi(r) in place (K1c)
    veff_multiply(fr.view(b, r, n), params.veff_r.view(ns, n))
    vbox = torch.fft.fftn(fr, dim=(-3, -2, -1)).view(b, r, n)
    del fr
    hpsi, spsi = box_to_pw_hpsi(vbox, psi, params.ekin, params.mask,
                                params.fft_index)
    if params.beta.shape[1]:
        # H psi += beta D <beta|psi>; spsi is the masked psi
        bp = torch.matmul(spsi, params.beta.mH)
        hpsi = torch.baddbmm(hpsi, torch.matmul(bp, params.dion), params.beta)
        if params.qmat is not None:
            # S psi += beta Q <beta|psi> (projectors are zero on padding)
            spsi = torch.baddbmm(spsi, torch.matmul(bp, params.qmat),
                                 params.beta)
    return hpsi, spsi
