"""K9: one atom chunk of beta projectors, generated on the fly
(csrc/beta_chunk.cu).

beta_chunk(pos, xi_rf, xi_lm, cph, rlm, q, mk, ri_grid, dq, pref, mask)
returns beta [C, nxi, ngk] complex128 for the C atoms of one chunk:

  beta[c, xi, g] = pref * cph[c, xi] * rlm[g, xi_lm[c, xi]]
                   * lerp(ri_grid[xi_rf[c, xi]], q[g] / dq) * mask[g]
                   * exp(-2 pi i mk[g] . pos[c])

pos [C, 3] lattice coordinates, xi_rf / xi_lm [C, nxi] int32, cph [C, nxi]
complex128 ((-i)^l, 0 on padded slots), rlm [ngk, lmmax], q / mask [ngk],
mk [ngk, 3] (G + k in lattice units), ri_grid [nrf, NQ] radial tables on a
uniform grid of step dq; mask may be None. Replaces the chunk build of
sirius_tpu/ops/beta_chunked.py::apply_h_s_chunked (:279-301) and
chunked_nonlocal (:144-170). A CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel.

Two instantiations, chosen by the type of q: float64 tables with complex128
cph and projectors (counted in beta_chunk.launches), and float32 tables with
complex64 cph and projectors (the fp32 wave-function path,
beta_chunk.launches_c64), where the index, weights and phase are float32,
as in the JAX package's make_chunked_hk(dtype=complex64).
"""

from __future__ import annotations

import math

import torch

from sirius_tpu_torch.kernels import build


def beta_chunk_plain(pos, xi_rf, xi_lm, cph, rlm, q, mk, ri_grid, dq: float,
                     pref: float, mask=None):
    iq = torch.clamp(q / dq, 0.0, ri_grid.shape[1] - 1.001)
    i0 = iq.to(torch.int64)
    t = iq - i0
    ri_all = ri_grid[:, i0] * (1.0 - t) + ri_grid[:, i0 + 1] * t
    if mask is not None:
        ri_all = ri_all * mask
    ri = ri_all[xi_rf.long()]  # [C, nxi, ngk]
    ang = rlm[:, xi_lm.long()].permute(1, 2, 0)  # [C, nxi, ngk]
    phase = torch.exp((-2j * math.pi) * (mk @ pos.T))  # [ngk, C]
    return pref * cph[:, :, None] * ang * ri * phase.T[:, None, :]


def beta_chunk(pos, xi_rf, xi_lm, cph, rlm, q, mk, ri_grid, dq: float,
               pref: float, mask=None):
    c, nxi = xi_rf.shape
    ngk, lmmax = rlm.shape
    dev = q.device
    if q.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"q must be float64 or float32, got {q.dtype}")
    real = q.dtype
    cplx = torch.complex128 if real == torch.float64 else torch.complex64
    _, suffix = build.variant(cplx)
    for name, t, dtype, shape in (
            ("pos", pos, real, (c, 3)),
            ("xi_rf", xi_rf, torch.int32, (c, nxi)),
            ("xi_lm", xi_lm, torch.int32, (c, nxi)),
            ("cph", cph, cplx, (c, nxi)),
            ("rlm", rlm, real, (ngk, lmmax)), ("q", q, real, (ngk,)),
            ("mk", mk, real, (ngk, 3)),
            ("ri_grid", ri_grid, real, (ri_grid.shape[0], ri_grid.shape[1])),
            ("mask", mask, real, (ngk,))):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if ri_grid.shape[1] < 2:
        raise ValueError("ri_grid needs at least two radial points")
    if dev.type == "cpu":
        return beta_chunk_plain(pos, xi_rf, xi_lm, cph, rlm, q, mk, ri_grid,
                                dq, pref, mask)
    if dev.type != "cuda":
        raise RuntimeError(f"beta_chunk: unsupported device {dev}")
    nq = ri_grid.shape[1]
    beta = torch.empty((c, nxi, ngk), dtype=cplx, device=dev)
    lib = build.library("beta_chunk")
    rc = getattr(lib, "beta_chunk" + suffix)(
        beta.data_ptr(), pos.contiguous().data_ptr(),
        xi_rf.contiguous().data_ptr(), xi_lm.contiguous().data_ptr(),
        cph.contiguous().data_ptr(), rlm.contiguous().data_ptr(),
        q.contiguous().data_ptr(), mk.contiguous().data_ptr(),
        None if mask is None else mask.contiguous().data_ptr(),
        ri_grid.contiguous().data_ptr(), c, nxi, ngk, lmmax, nq, float(dq),
        float(pref), float(nq - 1.001), build.stream_of(q))
    build.check(rc, "beta_chunk" + suffix)
    build.count_launch(beta_chunk, suffix)
    return beta


beta_chunk.launches = 0
beta_chunk.launches_c64 = 0
