"""Gamma-point real-storage band solve (the reference's "Gamma trick").

Mirrors sirius_tpu/ops/gamma.py. At k = 0 the Bloch coefficients of a
real-in-r wave function obey c(-G) = conj(c(G)). The packed layout keeps
the sphere's length but stores real numbers,

  x = [ c(0),  sqrt(2) Re c(G_1..G_P),  sqrt(2) Im c(G_1..G_P) ]

over one representative G of each (G, -G) pair. The map is an isometry
(sum_slots x_a x_b == Re <a|b> on the complex sphere), so the generic
solver (solvers/davidson.py) runs unchanged on these real vectors: its
subspace eigenproblems become real-symmetric (cuSOLVER syevd) and its band
GEMMs real.

The H application unpacks to the complex box (K8a), runs the
FFT-multiply-FFT local pipeline with the real-mode potential multiply
(K1c real: the box field is Hermitian-symmetric, so its real part is taken
before the multiply), and re-packs (K8b). The projectors are packed once
with the same isometry, so <beta|x> and the D/Q expansions are real matrix
products.

Host half (GammaMap, build_gamma_map, pack, unpack, pack_diags): numpy,
copied from the JAX package. Device half (GammaParams, apply_h_s_gamma,
davidson_gamma, density_gamma): tensors, float64 or, on the fp32
wave-function path, float32 (packed blocks and tables, complex64 boxes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.ops.hamiltonian import astype

SQRT2 = np.sqrt(2.0)


class GammaMap(NamedTuple):
    """Host-side pairing of the Gamma G-sphere (built once per context).

    Sphere-array index spaces: `rep`/`par` index into the ngk sphere
    arrays; packed layout is [zero | P representatives (Re) | P (Im)]."""

    zero: int  # sphere index of G = 0
    rep: np.ndarray  # [P] sphere index of each pair representative
    par: np.ndarray  # [P] sphere index of the partner -G
    # gather maps for device-side unpack (length ngk, sphere order):
    slot_re: np.ndarray  # packed slot holding Re of this G (or c0)
    slot_im: np.ndarray  # packed slot holding Im of this G (self for G=0)
    im_sign: np.ndarray  # +1 rep, -1 partner, 0 for G = 0
    scale: np.ndarray  # 1/sqrt2 for pairs, 1 for G = 0


def build_gamma_map(millers: np.ndarray, mask: np.ndarray) -> GammaMap:
    """millers: [ngk, 3] integer G of the Gamma sphere (valid where mask).

    Padded slots (mask == 0) are treated as extra 'zero' singletons mapped
    onto themselves with im_sign 0 — they stay exactly zero through the
    solve (the packed mask kills them)."""
    ngk = len(millers)
    valid = mask > 0
    index_of = {}
    for i in range(ngk):
        if valid[i]:
            index_of[tuple(int(v) for v in millers[i])] = i
    zero = index_of[(0, 0, 0)]
    rep, par = [], []
    seen = np.zeros(ngk, dtype=bool)
    seen[zero] = True
    for i in range(ngk):
        if seen[i] or not valid[i]:
            continue
        m = tuple(int(v) for v in millers[i])
        j = index_of.get((-m[0], -m[1], -m[2]))
        if j is None:
            raise ValueError(f"Gamma sphere not inversion-closed at G={m}")
        rep.append(i)
        par.append(j)
        seen[i] = seen[j] = True
    rep = np.asarray(rep, dtype=np.int32)
    par = np.asarray(par, dtype=np.int32)
    P = len(rep)
    slot_re = np.zeros(ngk, dtype=np.int32)
    slot_im = np.zeros(ngk, dtype=np.int32)
    im_sign = np.zeros(ngk)
    scale = np.ones(ngk)
    slot_re[zero] = 0
    slot_im[zero] = 0
    slot_re[rep] = 1 + np.arange(P)
    slot_im[rep] = 1 + P + np.arange(P)
    im_sign[rep] = 1.0
    scale[rep] = 1.0 / SQRT2
    slot_re[par] = 1 + np.arange(P)
    slot_im[par] = 1 + P + np.arange(P)
    im_sign[par] = -1.0
    scale[par] = 1.0 / SQRT2
    # padded slots: park them on their own packed positions past the data
    # region if any exist (ngk > 1 + 2P), else they'd alias slot 0
    pad = np.where(~valid)[0]
    if len(pad):
        base = 1 + 2 * P
        extra = base + np.arange(len(pad))
        if extra.max() >= ngk:
            raise ValueError("padded Gamma sphere inconsistent with pairing")
        slot_re[pad] = extra
        slot_im[pad] = extra
        im_sign[pad] = 0.0
        scale[pad] = 0.0
    return GammaMap(
        zero=int(zero), rep=rep, par=par, slot_re=slot_re,
        slot_im=slot_im, im_sign=im_sign, scale=scale,
    )


def pack(gm: GammaMap, c: np.ndarray) -> np.ndarray:
    """Complex sphere coefficients [..., ngk] -> packed real [..., ngk].

    Projects onto the Gamma-symmetric subspace (c(-G) := conj(c(G)) is
    enforced by construction, arbitrary input allowed)."""
    ngk = c.shape[-1]
    out = np.zeros(c.shape[:-1] + (ngk,), dtype=np.float64)
    out[..., 0] = np.real(c[..., gm.zero])
    # average the pair to make the projection exact for asymmetric input
    avg = 0.5 * (c[..., gm.rep] + np.conj(c[..., gm.par]))
    out[..., 1 : 1 + len(gm.rep)] = SQRT2 * np.real(avg)
    out[..., 1 + len(gm.rep) : 1 + 2 * len(gm.rep)] = SQRT2 * np.imag(avg)
    return out


def unpack(gm: GammaMap, x: np.ndarray) -> np.ndarray:
    """Packed real [..., ngk] -> complex sphere coefficients [..., ngk]."""
    xr = np.take(x, gm.slot_re, axis=-1)
    xi = np.take(x, gm.slot_im, axis=-1)
    return gm.scale * (xr + 1j * gm.im_sign * xi)


def pack_diags(gm: GammaMap, h_diag, o_diag):
    """Preconditioner diagonals [..., ngk] in packed order (values follow
    each slot's G; the packed H/S diagonals are exactly these by the
    isometry). Numpy arrays or tensors."""
    P = len(gm.rep)
    if isinstance(h_diag, torch.Tensor):
        hp = torch.full_like(h_diag, 1e4)
        op = torch.ones_like(o_diag)
        rep = torch.as_tensor(gm.rep, dtype=torch.long, device=h_diag.device)
    else:
        hp = np.full_like(h_diag, 1e4)
        op = np.ones_like(o_diag)
        rep = gm.rep
    hp[..., 0] = h_diag[..., gm.zero]
    op[..., 0] = o_diag[..., gm.zero]
    hp[..., 1 : 1 + P] = h_diag[..., rep]
    op[..., 1 : 1 + P] = o_diag[..., rep]
    hp[..., 1 + P : 1 + 2 * P] = h_diag[..., rep]
    op[..., 1 + P : 1 + 2 * P] = o_diag[..., rep]
    return hp, op


@dataclasses.dataclass
class GammaParams:
    """Tensors of the packed-real H/S application at Gamma: the JAX
    package's GammaParams leaves plus the box positions of each pair's two
    members, which K8b gathers from. The types below are the fp64 ones;
    astype(params, float32) gives the fp32 set."""

    veff_r: torch.Tensor  # [n1, n2, n3] float64
    ekin_p: torch.Tensor  # [ngk] kinetic at each packed slot's G
    mask_p: torch.Tensor  # [ngk] packed validity mask
    fft_index: torch.Tensor  # [ngk] int32 sphere scatter index (full set)
    slot_re: torch.Tensor  # [ngk] int32 gather maps (sphere order)
    slot_im: torch.Tensor  # [ngk] int32
    im_sign: torch.Tensor  # [ngk] float64
    scale: torch.Tensor  # [ngk] float64
    zero_idx: int  # sphere position of G = 0
    beta_p: torch.Tensor  # [nbeta, ngk] packed real projectors
    dion: torch.Tensor  # [nbeta, nbeta] float64 screened D
    qmat: torch.Tensor | None  # [nbeta, nbeta] float64; None where Q == 0
    rep_box: torch.Tensor  # [P] int32 box position of each representative
    par_box: torch.Tensor  # [P] int32 box position of each partner
    zero_box: int  # box position of G = 0

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.veff_r.shape)


def gamma_params_from_arrays(a: dict, device,
                             dtype=torch.float64) -> GammaParams:
    """GammaParams from host arrays under the JAX leaf names (veff_r,
    ekin_p, mask_p, fft_index, slot_re, slot_im, im_sign, scale, zero_idx,
    beta_p, dion, qmat), with real tables of dtype (float64, or float32 for
    the fp32 path). The pair tables of K8b are rebuilt from the
    gather maps: the representative of packed pair k is the lane with
    im_sign +1 and slot_re 1 + k, its partner the lane with im_sign -1."""
    device = resolve_device(device)
    slot_re = np.asarray(a["slot_re"], dtype=np.int64)
    im_sign = np.asarray(a["im_sign"], dtype=np.float64)
    fidx = np.asarray(a["fft_index"], dtype=np.int64)
    nbox = int(np.prod(np.shape(a["veff_r"])))
    if fidx.size and (fidx.min() < 0 or fidx.max() >= nbox):
        raise ValueError(f"fft_index outside the {nbox}-point box")
    ngk = len(slot_re)
    for name in ("slot_re", "slot_im"):
        idx = np.asarray(a[name])
        if idx.size and (idx.min() < 0 or idx.max() >= ngk):
            raise ValueError(f"{name} outside the {ngk} packed slots")
    rep_lanes = np.nonzero(im_sign > 0)[0]
    par_lanes = np.nonzero(im_sign < 0)[0]
    npair = len(rep_lanes)
    if len(par_lanes) != npair:
        raise ValueError("unpaired Gamma lanes in the gather maps")
    rep_box = np.empty(npair, dtype=np.int64)
    par_box = np.empty(npair, dtype=np.int64)
    rep_box[slot_re[rep_lanes] - 1] = fidx[rep_lanes]
    par_box[slot_re[par_lanes] - 1] = fidx[par_lanes]
    zero = int(a["zero_idx"])

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    f64, i32 = torch.float64, torch.int32
    qmat = np.asarray(a["qmat"])
    return astype(GammaParams(
        veff_r=t(a["veff_r"], f64), ekin_p=t(a["ekin_p"], f64),
        mask_p=t(a["mask_p"], f64), fft_index=t(fidx, i32),
        slot_re=t(slot_re, i32), slot_im=t(a["slot_im"], i32),
        im_sign=t(im_sign, f64), scale=t(a["scale"], f64), zero_idx=zero,
        beta_p=t(a["beta_p"], f64), dion=t(np.real(a["dion"]), f64),
        qmat=t(np.real(qmat), f64) if np.any(qmat != 0) else None,
        rep_box=t(rep_box, i32), par_box=t(par_box, i32),
        zero_box=int(fidx[zero])), dtype)


def make_gamma_params(ctx, veff_r_coarse, gm: GammaMap, dmat=None,
                      device=None, dtype=torch.float64) -> GammaParams:
    """GammaParams for ik = 0 of a Gamma-only context (D is the bare D_ion
    unless dmat is given). The constant tables (beta_p, gather maps, ekin)
    depend only on ctx: callers build once and swap veff_r and dion per
    iteration. device=None is the GPU and raises without CUDA; dtype
    float32 gives the fp32 tables (the JAX package's rdtype=)."""
    nbeta = ctx.beta.num_beta_total
    ngk = ctx.gkvec.ngk_max
    ekin = ctx.gkvec.kinetic()[0]
    # packed-slot kinetic: slot 0 -> G=0, Re/Im slots -> their pair's G
    ekin_p = np.zeros(ngk)
    ekin_p[0] = ekin[gm.zero]
    P = len(gm.rep)
    ekin_p[1 : 1 + P] = ekin[gm.rep]
    ekin_p[1 + P : 1 + 2 * P] = ekin[gm.rep]
    mask_p = np.zeros(ngk)
    mask_p[: 1 + 2 * P] = 1.0
    if nbeta:
        beta_p = pack(gm, np.asarray(ctx.beta.beta_gk[0]))
    else:
        beta_p = np.zeros((0, ngk))
    qmat = ctx.beta.qmat if ctx.beta.qmat is not None else np.zeros((nbeta, nbeta))
    dmat = ctx.beta.dion if dmat is None else dmat
    return gamma_params_from_arrays(dict(
        veff_r=np.asarray(veff_r_coarse, dtype=np.float64).reshape(
            tuple(ctx.fft_coarse.dims)),
        ekin_p=ekin_p, mask_p=mask_p, fft_index=ctx.gkvec.fft_index[0],
        slot_re=gm.slot_re, slot_im=gm.slot_im, im_sign=gm.im_sign,
        scale=gm.scale, zero_idx=gm.zero, beta_p=beta_p, dion=dmat,
        qmat=qmat), device, dtype)


def unpack_device(gp: GammaParams, x: torch.Tensor) -> torch.Tensor:
    """Packed real [..., ngk] -> complex sphere coefficients [..., ngk]
    (unpack on tensors; the fp64 params on float64 x give complex128, as
    the JAX package's host unpack of its float32 bands, scf.py:1439)."""
    xr = x[..., gp.slot_re.long()]
    xi = x[..., gp.slot_im.long()]
    return torch.complex(gp.scale * xr, gp.scale * gp.im_sign * xi)


def apply_h_s_gamma(gp: GammaParams, x: torch.Tensor):
    """(H x, S x) for a packed-real block x [B, R, ngk] (K8a, cuFFT, K1c in
    real mode, cuFFT, K8b, then the packed projectors' real products)."""
    from sirius_tpu_torch.kernels.gamma_pack import (box_to_packed_hx,
                                                     unpack_to_box)
    from sirius_tpu_torch.kernels.veff_multiply import veff_multiply_real

    apply_h_s_gamma.calls += 1
    b, r, _ = x.shape
    dims = gp.dims
    n = dims[0] * dims[1] * dims[2]
    box = unpack_to_box(x, gp.mask_p, gp.slot_re, gp.slot_im, gp.im_sign,
                        gp.scale, gp.fft_index, n)
    fr = torch.fft.ifftn(box.view((b, r) + dims), dim=(-3, -2, -1))
    del box
    # Hermitian-symmetric coefficients -> real field: drop the rounding-
    # level imaginary part BEFORE the potential multiply (K1c real mode)
    veff_multiply_real(fr.view(b, r, n), gp.veff_r.view(1, n))
    vbox = torch.fft.fftn(fr, dim=(-3, -2, -1)).view(b, r, n)
    del fr
    hx, sx = box_to_packed_hx(vbox, x, gp.ekin_p, gp.mask_p, gp.rep_box,
                              gp.par_box, gp.zero_box)
    del vbox
    if gp.beta_p.shape[0]:
        # sx is the masked x here
        bp = torch.matmul(sx, gp.beta_p.T)
        hx = hx + torch.matmul(torch.matmul(bp, gp.dion), gp.beta_p)
        if gp.qmat is not None:
            sx = sx + torch.matmul(torch.matmul(bp, gp.qmat), gp.beta_p)
    return hx * gp.mask_p, sx * gp.mask_p


apply_h_s_gamma.calls = 0


def davidson_gamma(gp: GammaParams, x0, h_diag_p, o_diag_p,
                   num_steps: int = 20, res_tol: float = 1e-6):
    """The generic solver on packed real blocks x0 [B, nb, ngk] with the
    packed diagonals [B, ngk] (subspace blocks real-symmetric, GEMMs real).
    Returns (evals [B, nb], X [B, nb, ngk], res_norms [B, nb])."""
    from sirius_tpu_torch.solvers.davidson import davidson

    mask = gp.mask_p.expand(x0.shape[0], -1)
    return davidson(apply_h_s_gamma, gp, x0, h_diag_p, o_diag_p, mask,
                    num_steps=num_steps, res_tol=res_tol)


def density_gamma(gp: GammaParams, x: torch.Tensor, occ_w: torch.Tensor):
    """Coarse-box density sum_b occ_w[b] |psi_b(r)|^2 from a packed-real
    band block x [nb, ngk] (Gamma-only k-set; occ_w includes the k-weight
    and max_occupancy). Returns [n1, n2, n3] float64. Plain PyTorch: the SCF
    takes the unpacked bands through density_kset instead."""
    from sirius_tpu_torch.kernels.gamma_pack import unpack_to_box_plain

    dims = gp.dims
    n = dims[0] * dims[1] * dims[2]
    box = unpack_to_box_plain(x[None], gp.mask_p, gp.slot_re, gp.slot_im,
                              gp.im_sign, gp.scale, gp.fft_index, n)[0]
    fr = torch.fft.ifftn(box.view((-1,) + dims), dim=(-3, -2, -1)) * n
    # Hermitian coefficients -> real field; |Re|^2 drops only rounding noise
    return torch.einsum("b,bxyz->xyz", occ_w, fr.real ** 2)
