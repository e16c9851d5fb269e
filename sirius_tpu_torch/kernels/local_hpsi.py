"""K1: the local part of H*psi around the FFTs (csrc/local_hpsi.cu).

Two entry points, each a wrapper that launches the CUDA kernel for a CUDA
tensor and takes the plain PyTorch version below for a CPU tensor:

  pw_to_box(psi, fft_index, mask)  [B, R, ngk] -> box [B, R, N]: zero fill,
      then psi stored at fft_index only where mask > 0;
  box_to_pw_hpsi(box, psi, ekin, mask, fft_index) -> (hpsi, spsi):
      hpsi = mask * (where(mask > 0, ekin, 0) * psi + box[fft_index]),
      spsi = mask * psi; with psi None it is the gather mask * box[fft_index].

fft_index and mask are [B, ngk] (one row per batch entry) or [ngk] (shared);
mask may be None (every lane valid). Replaces the fusions of
sirius_tpu/ops/hamiltonian.py::apply_h_s (:72-86).

Two instantiations: complex128 blocks with float64 ekin / mask, counted in
<wrapper>.launches, and complex64 blocks with float32 ones (the fp32
wave-function path), counted in <wrapper>.launches_c64. Mixed types raise.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def _check_block(name, t, shape=None, dtype=None):
    """Validate a complex block [B, rows, n] (complex128 or complex64, or
    dtype when given)."""
    ok = (t.dtype == dtype if dtype is not None
          else t.dtype in (torch.complex128, torch.complex64))
    if not ok or t.dim() != 3:
        raise ValueError(f"{name} must be {dtype or 'complex128 or complex64'}"
                         f" [B, rows, n], got {t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)} != {tuple(shape)}")


def _check_lanes(fft_index, mask, ekin, b, ngk, device, real=torch.float64):
    """Validate the per-lane tables (mask and ekin of the real type of the
    block); True when they carry a batch axis."""
    if fft_index.dtype != torch.int32:
        raise TypeError(f"fft_index must be int32, got {fft_index.dtype}")
    if tuple(fft_index.shape) not in ((b, ngk), (ngk,)):
        raise ValueError(f"fft_index {tuple(fft_index.shape)} does not "
                         f"match [B={b}, ngk={ngk}]")
    for name, t in (("fft_index", fft_index), ("mask", mask), ("ekin", ekin)):
        if t is None:
            continue
        if name != "fft_index" and (t.dtype != real
                                    or t.shape != fft_index.shape):
            raise ValueError(f"{name} must be {real} with fft_index's shape, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    return fft_index.dim() == 2


def pw_to_box_plain(psi, fft_index, mask, nbox):
    b, r, ngk = psi.shape
    src = psi if mask is None else torch.where(
        (mask > 0).reshape(-1, 1, ngk), psi, torch.zeros((), dtype=psi.dtype))
    box = torch.zeros((b, r, nbox), dtype=psi.dtype, device=psi.device)
    idx = fft_index.long().reshape(-1, 1, ngk).expand(b, r, ngk)
    # masked lanes add exact zeros (the JAX package's additive scatter)
    return box.scatter_add_(2, idx, src)


def pw_to_box(psi, fft_index, mask, nbox: int):
    """Scatter a sphere block [B, R, ngk] into a zeroed box [B, R, nbox]."""
    _check_block("psi", psi)
    real, suffix = build.variant(psi.dtype)
    batched = _check_lanes(fft_index, mask, None, psi.shape[0], psi.shape[2],
                           psi.device, real)
    if psi.device.type == "cpu":
        return pw_to_box_plain(psi, fft_index, mask, nbox)
    if psi.device.type != "cuda":
        raise RuntimeError(f"pw_to_box: unsupported device {psi.device}")
    psi = psi.contiguous()
    b, r, ngk = psi.shape
    box = torch.empty((b, r, nbox), dtype=psi.dtype, device=psi.device)
    lib = build.library("local_hpsi")
    rc = getattr(lib, "pw_to_box" + suffix)(
        psi.data_ptr(), fft_index.contiguous().data_ptr(),
        None if mask is None else mask.contiguous().data_ptr(),
        box.data_ptr(), b, r, ngk, nbox, int(batched), build.stream_of(psi))
    build.count_launch(pw_to_box, suffix)
    build.check(rc, "pw_to_box" + suffix)
    return box


pw_to_box.launches = 0
pw_to_box.launches_c64 = 0


def box_to_pw_hpsi_plain(box, psi, ekin, mask, fft_index):
    b, r, _ = box.shape
    ngk = fft_index.shape[-1]
    idx = fft_index.long().reshape(-1, 1, ngk).expand(b, r, ngk)
    v = torch.gather(box, 2, idx)
    m = 1.0 if mask is None else mask.reshape(-1, 1, ngk)
    if psi is None:
        return v * m, None
    ek = torch.where(mask > 0, ekin, 0.0).reshape(-1, 1, ngk)
    return (ek * psi + v) * m, psi * m


def box_to_pw_hpsi(box, psi, ekin, mask, fft_index):
    """Gather a transformed box back to the sphere, fused with the kinetic
    term and the mask: returns (hpsi, spsi) [B, R, ngk] (spsi None when psi
    is None)."""
    _check_block("box", box)
    real, suffix = build.variant(box.dtype)
    b, r, nbox = box.shape
    ngk = fft_index.shape[-1]
    if psi is not None:
        _check_block("psi", psi, (b, r, ngk), box.dtype)
        if ekin is None or mask is None:
            raise ValueError("ekin and mask are required with psi")
    batched = _check_lanes(fft_index, mask, ekin, b, ngk, box.device, real)
    if psi is not None and psi.device != box.device:
        raise ValueError("psi and box must be on one device")
    if box.device.type == "cpu":
        return box_to_pw_hpsi_plain(box, psi, ekin, mask, fft_index)
    if box.device.type != "cuda":
        raise RuntimeError(f"box_to_pw_hpsi: unsupported device {box.device}")
    box = box.contiguous()
    hpsi = torch.empty((b, r, ngk), dtype=box.dtype, device=box.device)
    spsi = None if psi is None else torch.empty_like(hpsi)
    if psi is not None:
        psi = psi.contiguous()
        ekin = ekin.contiguous()
    lib = build.library("local_hpsi")
    rc = getattr(lib, "box_to_pw" + suffix)(
        box.data_ptr(), None if psi is None else psi.data_ptr(),
        None if ekin is None else ekin.data_ptr(),
        None if mask is None else mask.contiguous().data_ptr(),
        fft_index.contiguous().data_ptr(), hpsi.data_ptr(),
        None if spsi is None else spsi.data_ptr(),
        b, r, ngk, nbox, int(batched), build.stream_of(box))
    build.count_launch(box_to_pw_hpsi, suffix)
    build.check(rc, "box_to_pw_hpsi" + suffix)
    return hpsi, spsi


box_to_pw_hpsi.launches = 0
box_to_pw_hpsi.launches_c64 = 0
