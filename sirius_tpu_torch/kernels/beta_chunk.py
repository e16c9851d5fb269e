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
    f64 = torch.float64
    for name, t, dtype, shape in (
            ("pos", pos, f64, (c, 3)), ("xi_rf", xi_rf, torch.int32, (c, nxi)),
            ("xi_lm", xi_lm, torch.int32, (c, nxi)),
            ("cph", cph, torch.complex128, (c, nxi)),
            ("rlm", rlm, f64, (ngk, lmmax)), ("q", q, f64, (ngk,)),
            ("mk", mk, f64, (ngk, 3)),
            ("ri_grid", ri_grid, f64, (ri_grid.shape[0], ri_grid.shape[1])),
            ("mask", mask, f64, (ngk,))):
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
    beta = torch.empty((c, nxi, ngk), dtype=torch.complex128, device=dev)
    lib = build.library("beta_chunk")
    rc = lib.beta_chunk(
        beta.data_ptr(), pos.contiguous().data_ptr(),
        xi_rf.contiguous().data_ptr(), xi_lm.contiguous().data_ptr(),
        cph.contiguous().data_ptr(), rlm.contiguous().data_ptr(),
        q.contiguous().data_ptr(), mk.contiguous().data_ptr(),
        None if mask is None else mask.contiguous().data_ptr(),
        ri_grid.contiguous().data_ptr(), c, nxi, ngk, lmmax, nq, float(dq),
        float(pref), float(nq - 1.001), build.stream_of(q))
    build.check(rc, "beta_chunk")
    beta_chunk.launches += 1
    return beta


beta_chunk.launches = 0
