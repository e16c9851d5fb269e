"""K10a / K10b: the G-space halves of the GGA gradient and divergence
(csrc/xc_gradient.cu).

  gradient_boxes(f, gcart, fft_index, nbox, box_to_g)  f [S, ng]
      complex128 -> [S, 3, nbox] complex128: i G_c f(G) at fft_index[G],
      zero elsewhere (the boxes the three inverse FFTs of
      potential.py::_gradient_r take);
  divergence_pw(boxes, gcart, fft_index)  [S, 3, nbox] complex128 (the
      forward FFTs of the three flux components) -> [S, ng]:
      sum_c i G_c boxes[s, c, fft_index[G]] (potential.py::_divergence_g).

gcart [ng, 3] float64 Cartesian G; fft_index [ng] int32, one-to-one on the
fine G set (dft/density.py::grid_tables checks it); box_to_g [nbox] int32
its inverse, -1 off the G set (GridTables.box_to_g), which the kernel walks
in box order. A CPU tensor takes the plain version (it reads fft_index, not
box_to_g); a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def _i_times(gc, v):
    """i G_c v = (-G_c Im v, G_c Re v)."""
    return torch.complex(-gc * v.imag, gc * v.real)


def gradient_boxes_plain(f, gcart, fft_index, nbox):
    s, ng = f.shape
    box = torch.zeros((s, 3, nbox), dtype=f.dtype, device=f.device)
    idx = fft_index.long()
    for c in range(3):
        box[:, c, idx] = _i_times(gcart[:, c], f)
    return box


def divergence_pw_plain(boxes, gcart, fft_index):
    v = boxes[:, :, fft_index.long()]  # [S, 3, ng]
    out = torch.zeros((boxes.shape[0], fft_index.shape[0]), dtype=boxes.dtype,
                      device=boxes.device)
    for c in range(3):
        out = out + _i_times(gcart[:, c], v[:, c])
    return out


def _check(name, t, gcart, fft_index):
    if t.dtype != torch.complex128:
        raise ValueError(f"{name} must be complex128, got {t.dtype}")
    ng = fft_index.shape[0]
    if fft_index.dtype != torch.int32 or fft_index.dim() != 1:
        raise ValueError("fft_index must be int32 [ng]")
    if gcart.dtype != torch.float64 or tuple(gcart.shape) != (ng, 3):
        raise ValueError(f"gcart must be float64 [{ng}, 3]")
    if gcart.device != t.device or fft_index.device != t.device:
        raise ValueError("inputs on more than one device")
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def gradient_boxes(f, gcart, fft_index, nbox: int, box_to_g):
    """[S, ng] -> [S, 3, nbox]: the three zero-filled boxes of i G_c f."""
    if f.dim() != 2 or f.shape[1] != fft_index.shape[0]:
        raise ValueError(f"f {tuple(f.shape)} is not [S, ng]")
    cuda = _check("f", f, gcart, fft_index)
    if (box_to_g.dtype != torch.int32 or box_to_g.dim() != 1
            or box_to_g.shape[0] != nbox):
        raise ValueError(f"box_to_g must be int32 [{nbox}]")
    if box_to_g.device != f.device:
        raise ValueError("inputs on more than one device")
    if not cuda:
        return gradient_boxes_plain(f, gcart, fft_index, nbox)
    f = f.contiguous()
    s, ng = f.shape
    box = torch.empty((s, 3, nbox), dtype=f.dtype, device=f.device)
    lib = build.library("xc_gradient")
    rc = lib.gradient_boxes(f.data_ptr(), gcart.contiguous().data_ptr(),
                            box_to_g.contiguous().data_ptr(), box.data_ptr(),
                            s, ng, nbox, build.stream_of(f))
    gradient_boxes.launches += 1
    build.check(rc, "gradient_boxes")
    return box


gradient_boxes.launches = 0


def divergence_pw(boxes, gcart, fft_index):
    """[S, 3, nbox] -> [S, ng]: sum_c i G_c F_c(G)."""
    if boxes.dim() != 3 or boxes.shape[1] != 3:
        raise ValueError(f"boxes {tuple(boxes.shape)} is not [S, 3, nbox]")
    if not _check("boxes", boxes, gcart, fft_index):
        return divergence_pw_plain(boxes, gcart, fft_index)
    boxes = boxes.contiguous()
    s, _, nbox = boxes.shape
    ng = fft_index.shape[0]
    out = torch.empty((s, ng), dtype=boxes.dtype, device=boxes.device)
    lib = build.library("xc_gradient")
    rc = lib.divergence_pw(boxes.data_ptr(), gcart.contiguous().data_ptr(),
                           fft_index.contiguous().data_ptr(), out.data_ptr(),
                           s, ng, nbox, build.stream_of(boxes))
    divergence_pw.launches += 1
    build.check(rc, "divergence_pw")
    return out


divergence_pw.launches = 0
