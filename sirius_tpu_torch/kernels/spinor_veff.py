"""K12a: the 2x2 spinor potential applied to the real-space box, in place
(csrc/spinor_veff.cu).

spinor_veff(fr, v_uu, v_dd, bx, by) updates fr [rows, 2, n] complex128 (spin
component 0 up, 1 down) in place:
    u' = u v_uu + d (bx - i by),   d' = d v_dd + u (bx + i by)
with the float64 coarse-box fields [n]. Replaces the fusion between the two
FFTs of sirius_tpu/ops/spinor.py::apply_h_s_nc (:58-66). A CPU tensor takes
the plain PyTorch version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def spinor_veff_plain(fr, v_uu, v_dd, bx, by):
    u, d = fr[:, 0].clone(), fr[:, 1].clone()
    bmix = torch.complex(bx, -by)
    fr[:, 0] = u * v_uu + d * bmix
    fr[:, 1] = d * v_dd + u * bmix.conj()
    return fr


def spinor_veff(fr, v_uu, v_dd, bx, by):
    """fr [rows, 2, n] complex128 <- the spinor potential times fr, in place;
    returns fr."""
    if fr.dtype != torch.complex128 or fr.dim() != 3 or fr.shape[1] != 2 \
            or not fr.is_contiguous():
        raise ValueError("fr must be a contiguous complex128 [rows, 2, n] "
                         "tensor")
    rows, _, n = fr.shape
    for name, v in (("v_uu", v_uu), ("v_dd", v_dd), ("bx", bx), ("by", by)):
        if v.dtype != torch.float64 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float64 [{n}]")
        if v.device != fr.device:
            raise ValueError(f"{name} is on {v.device}, fr on {fr.device}")
    if fr.device.type == "cpu":
        return spinor_veff_plain(fr, v_uu, v_dd, bx, by)
    if fr.device.type != "cuda":
        raise RuntimeError(f"spinor_veff: unsupported device {fr.device}")
    lib = build.library("spinor_veff")
    rc = lib.spinor_veff(fr.data_ptr(), v_uu.contiguous().data_ptr(),
                         v_dd.contiguous().data_ptr(),
                         bx.contiguous().data_ptr(), by.contiguous().data_ptr(),
                         rows, n, build.stream_of(fr))
    spinor_veff.launches += 1
    build.check(rc, "spinor_veff")
    return fr


spinor_veff.launches = 0
