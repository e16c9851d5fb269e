"""K17d: the two passes around the potential's coarse inverse FFT
(csrc/potential_passes.cu coarse_fill, coarse_stack), and the plain
versions.

coarse_fill(fields, table) takes one to four fine-G fields ([ng]
complex128: V_eff; V_eff and B_z; the v_tau rows of mGGA) and the
[n_coarse_box] int32 table of dft/density.py::grid_tables
(`coarse_box_to_fine`: every coarse box slot to the fine G of the same G,
-1 outside the coarse sphere, built by coarse_box_to_fine below) and
returns the [n_fields, n_coarse_box] complex128 boxes, a row a field, every
slot written once in one launch: the field's value at that G, or zero. It
replaces the gather f_g[coarse_to_fine] and K1's scatter into a zeroed
coarse box of sirius_tpu/dft/potential.py::generate_potential_device
:356-358, and the same pair in the non-collinear potential (V, B_x, B_y,
B_z).

coarse_stack(boxes, spin) takes the inverse-transformed coarse boxes
(complex128 [n1, n2, n3] each) and returns the float64 [ns, n1, n2, n3]
potential the band solve reads: [Re V + Re B, Re V - Re B] where spin
(boxes V, B_z), else [Re f] for each box. It replaces :360-365.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.kernels import build

MAX_FIELDS = 4


def coarse_box_to_fine(fft_index_coarse, coarse_to_fine, nbox: int,
                       ng: int) -> np.ndarray:
    """[nbox] int32: for every coarse box slot the fine G of the same G
    (coarse_to_fine of the coarse G stored there), -1 where no coarse G is
    stored. Raises unless the coarse G map one-to-one into the box and
    into the fine set (the inverse of density_scatter.fine_to_coarse_box)."""
    idx = np.asarray(fft_index_coarse, dtype=np.int64)
    c2f = np.asarray(coarse_to_fine, dtype=np.int64)
    if c2f.shape != idx.shape or (c2f.size and (
            c2f.min() < 0 or c2f.max() >= ng or idx.min() < 0
            or idx.max() >= nbox)):
        raise ValueError("coarse_to_fine must map every coarse G into the "
                         "fine set, fft_index_coarse into the coarse box")
    if np.unique(c2f).size != c2f.size:
        raise ValueError("coarse_to_fine maps two coarse G to one fine G")
    if np.unique(idx).size != idx.size:
        raise ValueError("fft_index_coarse maps two coarse G to one slot")
    table = np.full(nbox, -1, dtype=np.int32)
    table[idx] = c2f
    return table


def coarse_fill_plain(fields, table) -> torch.Tensor:
    t = table.long()
    slots = torch.nonzero(t >= 0).reshape(-1)
    src = t[slots]
    out = torch.zeros((len(fields), t.shape[0]), dtype=torch.complex128,
                      device=fields[0].device)
    for box, f in zip(out, fields):
        box[slots] = f[src]
    return out


def coarse_fill(fields, table) -> torch.Tensor:
    """The zero-padded coarse boxes of fine-G fields, a row a field (K17d
    fill on a CUDA tensor, every field in one launch)."""
    fields = list(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"coarse_fill takes 1 to {MAX_FIELDS} fields")
    ref = fields[0]
    if ref.dim() != 1:
        raise ValueError("coarse_fill: fields must be [ng]")
    build.check_fields("coarse_fill", torch.complex128, ref,
                       *((f"field {i}", f) for i, f in enumerate(fields)))
    if (table.dtype != torch.int32 or table.dim() != 1
            or table.device != ref.device):
        raise ValueError("coarse_fill: table must be int32 [nbox] on the "
                         "device of the fields")
    if not build.on_cuda(ref, "coarse_fill"):
        return coarse_fill_plain(fields, table)
    fields = [f.contiguous() for f in fields]
    table = table.contiguous()
    nbox = table.shape[0]
    out = torch.empty((len(fields), nbox), dtype=torch.complex128,
                      device=ref.device)
    pad = [None] * (MAX_FIELDS - len(fields))
    rc = build.library("potential_passes").coarse_fill(
        *[f.data_ptr() for f in fields], *pad, len(fields), table.data_ptr(),
        nbox, *[b.data_ptr() for b in out], *pad, build.stream_of(ref))
    coarse_fill.launches += 1
    build.check(rc, "coarse_fill")
    return out


coarse_fill.launches = 0


def coarse_stack_plain(boxes, spin: bool) -> torch.Tensor:
    if spin:
        v_r, b_r = boxes[0].real, boxes[1].real
        return torch.stack([v_r + b_r, v_r - b_r])
    return torch.stack([b.real for b in boxes])


def coarse_stack(boxes, spin: bool) -> torch.Tensor:
    """The per-spin float64 coarse potential of the transformed boxes
    (K17d stack on a CUDA tensor)."""
    boxes = list(boxes)
    if not 1 <= len(boxes) <= MAX_FIELDS or (spin and len(boxes) != 2):
        raise ValueError(f"coarse_stack takes 1 to {MAX_FIELDS} boxes, two "
                         "(V, B_z) with spin")
    ref = boxes[0]
    build.check_fields("coarse_stack", torch.complex128, ref,
                       *((f"box {i}", b) for i, b in enumerate(boxes)))
    if not build.on_cuda(ref, "coarse_stack"):
        return coarse_stack_plain(boxes, spin)
    boxes = [b.contiguous() for b in boxes]
    out = torch.empty((len(boxes),) + tuple(ref.shape), dtype=torch.float64,
                      device=ref.device)
    pad = [None] * (MAX_FIELDS - len(boxes))
    rc = build.library("potential_passes").coarse_stack(
        *[b.data_ptr() for b in boxes], *pad, len(boxes), int(spin),
        ref.numel(), out.data_ptr(), build.stream_of(ref))
    coarse_stack.launches += 1
    build.check(rc, "coarse_stack")
    return out


coarse_stack.launches = 0
