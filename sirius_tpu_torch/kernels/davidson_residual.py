"""K2: Davidson residual, convergence mask and Teter preconditioner
(csrc/davidson_residual.cu).

davidson_residual(x, hx, sx, h_diag, o_diag, mask, res_tol) on blocks
[B, nb, ngk] returns (evals [B, nb], rnorm [B, nb], w [B, nb, ngk]):

  evals = Re<x|hx> / Re<x|sx>   (denominator guarded, davidson.py:141-144)
  r     = (hx - evals sx) * mask,  rnorm = |r| per row,  conv = rnorm < res_tol
  p     = h_diag - evals o_diag,   p <- (1 + p + sqrt(1 + (p - 1)^2)) / 2
  w     = where(conv, 0, r / p) * mask

With want_w=False it returns (evals, rnorm, None) with no mask applied: the
exit values of davidson (davidson.py:209-213). A CPU tensor takes the plain
PyTorch version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def davidson_residual_plain(x, hx, sx, h_diag, o_diag, mask, res_tol,
                            want_w=True):
    den = torch.sum(x.conj() * sx, dim=-1).real
    num = torch.sum(x.conj() * hx, dim=-1).real
    evals = num / torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
    r = hx - evals[..., None] * sx
    if want_w:
        r = r * mask[:, None, :]
    rnorm = torch.sqrt(torch.sum(r.abs() ** 2, dim=-1))
    if not want_w:
        return evals, rnorm, None
    p = h_diag[:, None, :] - evals[..., None] * o_diag[:, None, :]
    p = 0.5 * (1.0 + p + torch.sqrt(1.0 + (p - 1.0) ** 2))
    conv = (rnorm < res_tol)[..., None]
    w = torch.where(conv, torch.zeros((), dtype=r.dtype), r / p)
    return evals, rnorm, w * mask[:, None, :]


def davidson_residual(x, hx, sx, h_diag, o_diag, mask, res_tol: float,
                      want_w: bool = True):
    for name, t in (("x", x), ("hx", hx), ("sx", sx)):
        if t.dtype != torch.complex128 or t.dim() != 3:
            raise ValueError(f"{name} must be complex128 [B, nb, ngk]")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} does not match x {tuple(x.shape)}")
    b, nb, ngk = x.shape
    tables = (h_diag, o_diag, mask) if want_w else ()
    for t in tables:
        if t.dtype != torch.float64 or tuple(t.shape) != (b, ngk) \
                or t.device != x.device:
            raise ValueError("h_diag, o_diag, mask must be float64 [B, ngk] "
                             "on x's device")
    if x.device.type == "cpu":
        return davidson_residual_plain(x, hx, sx, h_diag, o_diag, mask,
                                       res_tol, want_w)
    if x.device.type != "cuda":
        raise RuntimeError(f"davidson_residual: unsupported device {x.device}")
    x, hx, sx = x.contiguous(), hx.contiguous(), sx.contiguous()
    evals = torch.empty((b, nb), dtype=torch.float64, device=x.device)
    rnorm = torch.empty_like(evals)
    w = torch.empty_like(x) if want_w else None
    tabs = [t.contiguous() for t in tables]
    lib = build.library("davidson_residual")
    rc = lib.davidson_residual(
        x.data_ptr(), hx.data_ptr(), sx.data_ptr(),
        tabs[0].data_ptr() if want_w else None,
        tabs[1].data_ptr() if want_w else None,
        tabs[2].data_ptr() if want_w else None,
        float(res_tol), evals.data_ptr(), rnorm.data_ptr(),
        None if w is None else w.data_ptr(), b * nb, nb, ngk,
        build.stream_of(x))
    davidson_residual.launches += 1
    build.check(rc, "davidson_residual")
    return evals, rnorm, w


davidson_residual.launches = 0
