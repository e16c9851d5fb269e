"""K11a / K11b: the sphere <-> box halves of the meta-GGA tau operator
(csrc/mgga_tau.cu).

  grad_to_box(psi, gkc, comp, fft_index, mask, nbox)  [B, R, ngk] -> box
      [B, R, nbox]: zero fill, then gkc[..., comp] * psi stored at
      fft_index only where mask > 0 (K11a);
  box_to_pw_tau(box, gkc, comp, fft_index, mask, hpsi): the gather
      back = box[fft_index], hpsi += (0.5 gkc[..., comp] back) mask in
      place (K11b).

fft_index and mask are [B, ngk] (one row per batch entry) or [ngk]
(shared), gkc [B, ngk, 3] or [ngk, 3] the Cartesian G+k vectors. Replaces
the fusions of sirius_tpu/ops/mgga.py::apply_h_s_mgga (:42-55) and
tau_kset (:72-77). A CPU tensor takes the plain PyTorch version; a CUDA
tensor launches the kernel.

Two instantiations: complex128 blocks with float64 gkc / mask (counted in
<wrapper>.launches), and complex64 blocks with float32 ones (the fp32
wave-function path, <wrapper>.launches_c64).
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels.local_hpsi import (_check_block, _check_lanes,
                                                 pw_to_box_plain)


def _check_gkc(gkc, fft_index, comp: int, real):
    if gkc.dtype != real or tuple(gkc.shape) != (*fft_index.shape, 3):
        raise ValueError(f"gkc must be {real} {(*fft_index.shape, 3)}, got "
                         f"{gkc.dtype} {tuple(gkc.shape)}")
    if gkc.device != fft_index.device:
        raise ValueError("gkc and fft_index must be on one device")
    if comp not in (0, 1, 2):
        raise ValueError(f"comp must be 0, 1 or 2, got {comp}")


def _component(gkc, comp: int, ngk: int):
    return gkc[..., comp].reshape(-1, 1, ngk)


def grad_to_box_plain(psi, gkc, comp, fft_index, mask, nbox):
    return pw_to_box_plain(_component(gkc, comp, psi.shape[2]) * psi,
                           fft_index, mask, nbox)


def grad_to_box(psi, gkc, comp: int, fft_index, mask, nbox: int):
    """Scatter (G+k)_comp psi [B, R, ngk] into a zeroed box [B, R, nbox]."""
    _check_block("psi", psi)
    real, suffix = build.variant(psi.dtype)
    b, r, ngk = psi.shape
    batched = _check_lanes(fft_index, mask, None, b, ngk, psi.device, real)
    if mask is None:
        raise ValueError("grad_to_box needs the lane mask")
    _check_gkc(gkc, fft_index, comp, real)
    if psi.device.type == "cpu":
        return grad_to_box_plain(psi, gkc, comp, fft_index, mask, nbox)
    if psi.device.type != "cuda":
        raise RuntimeError(f"grad_to_box: unsupported device {psi.device}")
    psi = psi.contiguous()
    box = torch.empty((b, r, nbox), dtype=psi.dtype, device=psi.device)
    lib = build.library("mgga_tau")
    rc = getattr(lib, "grad_to_box" + suffix)(
        psi.data_ptr(), gkc.contiguous().data_ptr(), comp,
        fft_index.contiguous().data_ptr(), mask.contiguous().data_ptr(),
        box.data_ptr(), b, r, ngk, nbox, int(batched), build.stream_of(psi))
    build.count_launch(grad_to_box, suffix)
    build.check(rc, "grad_to_box" + suffix)
    return box


grad_to_box.launches = 0
grad_to_box.launches_c64 = 0


def box_to_pw_tau_plain(box, gkc, comp, fft_index, mask, hpsi):
    b, r, _ = box.shape
    ngk = fft_index.shape[-1]
    idx = fft_index.long().reshape(-1, 1, ngk).expand(b, r, ngk)
    gv = _component(gkc, comp, ngk) * torch.gather(box, 2, idx)
    return hpsi.add_((0.5 * gv) * mask.reshape(-1, 1, ngk))


def box_to_pw_tau(box, gkc, comp: int, fft_index, mask, hpsi):
    """hpsi [B, R, ngk] += (0.5 (G+k)_comp box[fft_index]) mask, in place.
    Returns hpsi."""
    _check_block("box", box)
    real, suffix = build.variant(box.dtype)
    b, r, nbox = box.shape
    ngk = fft_index.shape[-1]
    _check_block("hpsi", hpsi, (b, r, ngk), box.dtype)
    if not hpsi.is_contiguous() or hpsi.device != box.device:
        raise ValueError("hpsi must be contiguous, on the box's device")
    batched = _check_lanes(fft_index, mask, None, b, ngk, box.device, real)
    if mask is None:
        raise ValueError("box_to_pw_tau needs the lane mask")
    _check_gkc(gkc, fft_index, comp, real)
    if box.device.type == "cpu":
        return box_to_pw_tau_plain(box, gkc, comp, fft_index, mask, hpsi)
    if box.device.type != "cuda":
        raise RuntimeError(f"box_to_pw_tau: unsupported device {box.device}")
    box = box.contiguous()
    lib = build.library("mgga_tau")
    rc = getattr(lib, "box_to_pw_tau" + suffix)(
        box.data_ptr(), gkc.contiguous().data_ptr(), comp,
        fft_index.contiguous().data_ptr(), mask.contiguous().data_ptr(),
        hpsi.data_ptr(), b, r, ngk, nbox, int(batched), build.stream_of(box))
    build.count_launch(box_to_pw_tau, suffix)
    build.check(rc, "box_to_pw_tau" + suffix)
    return hpsi


box_to_pw_tau.launches = 0
box_to_pw_tau.launches_c64 = 0
