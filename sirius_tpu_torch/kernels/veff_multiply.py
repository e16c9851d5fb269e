"""K1c: the local potential applied to the real-space box, in place
(csrc/veff_multiply.cu).

veff_multiply(fr, veff) multiplies fr [B, R, n] complex128 in place by
veff[b % ns] for batch entry b, veff [ns, n] float64 (b = ik * ns + ispn).
Replaces `fr * params.veff_r` of sirius_tpu/ops/hamiltonian.py::apply_h_s
(:79-82). veff_multiply_real(fr, veff) is the real mode of the Gamma path,
fr <- Re(fr) * veff + 0i in place (sirius_tpu/ops/gamma.py::apply_h_s_gamma
:230-233), with its own launch count. A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel.
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


def _check(fr, veff):
    if fr.dtype != torch.complex128 or fr.dim() != 3 or not fr.is_contiguous():
        raise ValueError("fr must be a contiguous complex128 [B, R, n] tensor")
    b, r, n = fr.shape
    if veff.dtype != torch.float64 or veff.dim() != 2 or veff.shape[1] != n:
        raise ValueError(f"veff must be float64 [ns, {n}]")
    ns = veff.shape[0]
    if ns < 1 or b % ns:
        raise ValueError(f"batch {b} is not a multiple of ns = {ns}")
    if veff.device != fr.device:
        raise ValueError("fr and veff must be on one device")
    if fr.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"veff_multiply: unsupported device {fr.device}")


def _launch(fn: str, fr, veff) -> None:
    b, r, n = fr.shape
    veff = veff.contiguous()
    lib = build.library("veff_multiply")
    rc = getattr(lib, fn)(fr.data_ptr(), veff.data_ptr(), b, r, veff.shape[0],
                          n, build.stream_of(fr))
    build.check(rc, fn)


def veff_multiply(fr, veff):
    """fr [B, R, n] complex128 *= veff[b % ns], in place; returns fr."""
    _check(fr, veff)
    if fr.device.type == "cpu":
        return veff_multiply_plain(fr, veff)
    _launch("veff_multiply", fr, veff)
    veff_multiply.launches += 1
    return fr


veff_multiply.launches = 0


def veff_multiply_real(fr, veff):
    """fr [B, R, n] complex128 <- Re(fr) * veff[b % ns] + 0i, in place;
    returns fr."""
    _check(fr, veff)
    if fr.device.type == "cpu":
        return veff_multiply_real_plain(fr, veff)
    _launch("veff_multiply_real", fr, veff)
    veff_multiply_real.launches += 1
    return fr


veff_multiply_real.launches = 0
