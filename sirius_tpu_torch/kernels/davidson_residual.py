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
version; a CUDA tensor launches the kernel, on the grid
davidson_residual_plan sizes: one block a row for short rows, else a
cluster of C blocks a row, each holding its slice of x, hx and sx in shared
memory.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build

# csrc/davidson_residual.cu: threads a block, and the static shared memory
# of its cluster kernel (two reals a warp and the partial sums, with room)
THREADS = 256
STATIC_SHARED = 512
# an H100 SM's shared memory (228 KB) and what each resident block
# reserves of it (1 KB); the clustered kernel plans two blocks an SM
SHARED_SM = 233472
BLOCK_RESERVED = 1024
BLOCKS_PER_SM = 2
# an SM holds at most 2048 threads: 8 blocks of THREADS
MAX_BLOCKS_PER_SM = 2048 // THREADS
SLICE_BUDGET = SHARED_SM // BLOCKS_PER_SM - BLOCK_RESERVED - STATIC_SHARED
# rows shorter than this (every 2-atom deck's) take one block a row
SMALL_ROW_BYTES = 32 * 1024
CLUSTERS = (2, 4, 8)


def davidson_residual_plan(nrows: int, ngk: int, element_bytes: int,
                           sm_count: int) -> dict:
    """K2's grid for nrows rows of ngk elements of element_bytes bytes.

    cluster 1: one block a row (rows under SMALL_ROW_BYTES, or rows no
    cluster's slices fit). Else the cluster size C of 2, 4, 8 whose slice of
    the three blocks x, hx, sx (3 * slice * element_bytes shared bytes,
    slice = ceil(ngk / C) elements) leaves room for BLOCKS_PER_SM blocks an
    SM: the smallest such C where its nrows * C blocks all fit on the card
    at once (one wave: fewer, longer blocks wait less for their clusters),
    else the largest (more waves: the shorter each block's chain of waits
    and passes, the sooner the next wave starts). Block r of a row's
    cluster takes elements [r * slice, min(ngk, (r + 1) * slice))."""
    row_bytes = ngk * element_bytes
    cluster = 1
    if row_bytes >= SMALL_ROW_BYTES:
        fits = [c for c in CLUSTERS
                if 3 * -(-ngk // c) * element_bytes <= SLICE_BUDGET]
        if fits:
            c = fits[0]
            resident = sm_count * min(
                MAX_BLOCKS_PER_SM, (SHARED_SM // (
                    3 * -(-ngk // c) * element_bytes + STATIC_SHARED
                    + BLOCK_RESERVED)))
            cluster = c if nrows * c <= resident else fits[-1]
    slice_ = -(-ngk // cluster)
    return {"cluster": cluster, "slice": slice_, "blocks": nrows * cluster,
            "shared": 3 * slice_ * element_bytes if cluster > 1 else 0}


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
    if w is not None and w.data_ptr() % 16:
        raise RuntimeError("davidson_residual: w is not 16-byte aligned")
    plan = davidson_residual_plan(b * nb, ngk, x.element_size(),
                                  build.sm_count(x.device))
    lib = build.library("davidson_residual")
    fn = getattr(lib, "davidson_residual" + suffix)
    rc = fn(
        x.data_ptr(), hx.data_ptr(), sx.data_ptr(),
        tabs[0].data_ptr() if want_w else None,
        tabs[1].data_ptr() if want_w else None,
        tabs[2].data_ptr() if want_w else None,
        float(res_tol), evals.data_ptr(), rnorm.data_ptr(),
        None if w is None else w.data_ptr(), b * nb, nb, ngk,
        plan["cluster"], plan["slice"], build.stream_of(x))
    build.check(rc, "davidson_residual" + suffix)
    build.count_launch(davidson_residual, suffix)
    return evals, rnorm, w


davidson_residual.launches = 0
davidson_residual.launches_f64 = 0
davidson_residual.launches_c64 = 0
davidson_residual.launches_f32 = 0
