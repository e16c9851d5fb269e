"""K1c: the local potential applied to the real-space box, in place
(csrc/veff_multiply.cu).

veff_multiply(fr, veff) multiplies fr [B, R, n] complex128 in place by
veff[b % ns] for batch entry b, veff [ns, n] float64 (b = ik * ns + ispn).
Replaces `fr * params.veff_r` of sirius_tpu/ops/hamiltonian.py::apply_h_s
(:79-82). veff_multiply_real(fr, veff) is the real mode of the Gamma path,
fr <- Re(fr) * veff + 0i in place (sirius_tpu/ops/gamma.py::apply_h_s_gamma
:230-233), with its own launch count. A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel.

Both modes have two instantiations: complex128 boxes with a float64
potential (counted in <wrapper>.launches) and complex64 boxes with a float32
potential (the fp32 wave-function path, <wrapper>.launches_c64).

The kernel moves 16-byte vectors (two complex64 or one complex128
element), one block per row and tile of 256 vectors.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def veff_multiply_plain(fr, veff):
    b, r, n = fr.shape
    ns = veff.shape[0]
    fr.view(b // ns, ns, r, n).mul_(veff[None, :, None, :])
    return fr


def veff_multiply_real_plain(fr, veff):
    b, r, n = fr.shape
    ns = veff.shape[0]
    parts = torch.view_as_real(fr).view(b // ns, ns, r, n, 2)
    parts[..., 0].mul_(veff[None, :, None, :])
    parts[..., 1].zero_()
    return fr


def _check(fr, veff) -> str:
    """Validate the operands; returns the instantiation's suffix."""
    if fr.dtype not in (torch.complex128, torch.complex64) or fr.dim() != 3 \
            or not fr.is_contiguous():
        raise ValueError("fr must be a contiguous complex128 or complex64 "
                         "[B, R, n] tensor")
    real, suffix = build.variant(fr.dtype)
    b, r, n = fr.shape
    if veff.dtype != real or veff.dim() != 2 or veff.shape[1] != n:
        raise ValueError(f"veff must be {real} [ns, {n}] for {fr.dtype} fr, "
                         f"got {veff.dtype} {tuple(veff.shape)}")
    ns = veff.shape[0]
    if ns < 1 or b % ns:
        raise ValueError(f"batch {b} is not a multiple of ns = {ns}")
    if veff.device != fr.device:
        raise ValueError("fr and veff must be on one device")
    if fr.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"veff_multiply: unsupported device {fr.device}")
    return suffix


def _launch(fn: str, fr, veff) -> None:
    b, r, n = fr.shape
    if fr.data_ptr() % fr.element_size():
        # the kernel's vectors start on element boundaries (a complex128
        # element is a whole 16-byte vector)
        raise ValueError("fr's data pointer is not aligned to its element")
    veff = veff.contiguous()
    lib = build.library("veff_multiply")
    rc = getattr(lib, fn)(fr.data_ptr(), veff.data_ptr(), b, r, veff.shape[0],
                          n, build.stream_of(fr))
    build.check(rc, fn)


def veff_multiply(fr, veff):
    """fr [B, R, n] *= veff[b % ns], in place; returns fr."""
    suffix = _check(fr, veff)
    if fr.device.type == "cpu":
        return veff_multiply_plain(fr, veff)
    _launch("veff_multiply" + suffix, fr, veff)
    build.count_launch(veff_multiply, suffix)
    return fr


veff_multiply.launches = 0
veff_multiply.launches_c64 = 0


def veff_multiply_real(fr, veff):
    """fr [B, R, n] <- Re(fr) * veff[b % ns] + 0i, in place; returns fr."""
    suffix = _check(fr, veff)
    if fr.device.type == "cpu":
        return veff_multiply_real_plain(fr, veff)
    _launch("veff_multiply_real" + suffix, fr, veff)
    build.count_launch(veff_multiply_real, suffix)
    return fr


veff_multiply_real.launches = 0
veff_multiply_real.launches_c64 = 0
