"""K2: Davidson residual, convergence mask and Teter preconditioner
(csrc/davidson_residual.cu).

davidson_residual(x, hx, sx, h_diag, o_diag, mask, res_tol) on blocks
[B, nb, ngk] returns (evals [B, nb], rnorm [B, nb], w [B, nb, ngk]):

  evals = Re<x|hx> / Re<x|sx>   (denominator guarded, davidson.py:141-144)
  r     = (hx - evals sx) * mask,  rnorm = |r| per row,  conv = rnorm < res_tol
  p     = h_diag - evals o_diag,   p <- (1 + p + sqrt(1 + (p - 1)^2)) / 2
  w     = where(conv, 0, r / p) * mask

With want_w=False it returns (evals, rnorm, None) with no mask applied: the
exit values of davidson (davidson.py:209-213). The blocks are complex128
(k-point path) or float64 (the Gamma packed-real path), with float64
tables and results, or on the fp32 wave-function path complex64 or
float32, with float32 tables and float32 evals and rnorm (reduced in
float32, as the JAX package's complex64 davidson): one kernel source, four
instantiations counted apart in davidson_residual.launches, .launches_f64,
.launches_c64 and .launches_f32. A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel.
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
    if x.dtype not in (torch.complex128, torch.float64, torch.complex64,
                       torch.float32):
        raise ValueError(f"x must be complex128, float64, complex64 or "
                         f"float32, got {x.dtype}")
    real, suffix = build.variant(x.dtype)
    if x.dtype == torch.float64:
        suffix = "_f64"
    for name, t in (("x", x), ("hx", hx), ("sx", sx)):
        if t.dtype != x.dtype or t.dim() != 3:
            raise ValueError(f"{name} must be {x.dtype} [B, nb, ngk]")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} does not match x {tuple(x.shape)}")
    b, nb, ngk = x.shape
    tables = (h_diag, o_diag, mask) if want_w else ()
    for t in tables:
        if t.dtype != real or tuple(t.shape) != (b, ngk) \
                or t.device != x.device:
            raise ValueError(f"h_diag, o_diag, mask must be {real} [B, ngk] "
                             f"on x's device, got {t.dtype}")
    if x.device.type == "cpu":
        return davidson_residual_plain(x, hx, sx, h_diag, o_diag, mask,
                                       res_tol, want_w)
    if x.device.type != "cuda":
        raise RuntimeError(f"davidson_residual: unsupported device {x.device}")
    x, hx, sx = x.contiguous(), hx.contiguous(), sx.contiguous()
    evals = torch.empty((b, nb), dtype=real, device=x.device)
    rnorm = torch.empty_like(evals)
    w = torch.empty_like(x) if want_w else None
    tabs = [t.contiguous() for t in tables]
    lib = build.library("davidson_residual")
    fn = getattr(lib, "davidson_residual" + suffix)
    rc = fn(
        x.data_ptr(), hx.data_ptr(), sx.data_ptr(),
        tabs[0].data_ptr() if want_w else None,
        tabs[1].data_ptr() if want_w else None,
        tabs[2].data_ptr() if want_w else None,
        float(res_tol), evals.data_ptr(), rnorm.data_ptr(),
        None if w is None else w.data_ptr(), b * nb, nb, ngk,
        build.stream_of(x))
    build.check(rc, "davidson_residual" + suffix)
    build.count_launch(davidson_residual, suffix)
    return evals, rnorm, w


davidson_residual.launches = 0
davidson_residual.launches_f64 = 0
davidson_residual.launches_c64 = 0
davidson_residual.launches_f32 = 0
