"""K15: the fused SCF step's scalar record as one batched reduction
(csrc/scf_record.cu), and its plain version.

scf_record(segments, nslots) returns a float64 [nslots] record on the
device of the segments' tensors. Each Segment is one reduction over one
vector (op, see OPS), times its scale, into a slot; a slot is the sum
(sum, dot, dot_c), the max (maxabs_c, maxabs, eye, herm) or the
all-finite flag (finite) of its segments, combined in table order; a slot
no segment names is 0. Replaces the scalar reductions of
sirius_tpu/dft/fused.py::_step_impl (:400-459), which XLA fuses into the
JAX package's jitted step. A CPU tensor takes the plain version
(scf_record_plain, torch reductions); CUDA tensors launch the kernel, the
segment table passed by value in the launch (nothing is uploaded, so the
call never waits on the host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.kernels import build

# op -> (number in csrc/scf_record.cu, the combine of its slot, input type)
OPS = {"sum": (0, "sum", torch.float64), "dot": (1, "sum", torch.float64),
       "dot_c": (2, "sum", torch.complex128),
       "maxabs_c": (3, "max", torch.complex128),
       "maxabs": (4, "max", torch.float64),
       "eye": (5, "max", torch.complex128),
       "herm": (6, "max", torch.complex128),
       "finite": (7, "finite", torch.float64)}
MAX_SEGMENTS = 40
_MAX_BLOCKS = 128  # csrc/scf_record.cu kMaxBlocks


@dataclasses.dataclass
class Segment:
    """One reduction of the record: op over a (and b), times scale, into
    slot. eye and herm read a as matrices [..., param, param]."""
    op: str
    slot: int
    a: torch.Tensor
    b: torch.Tensor | None = None
    scale: float = 1.0
    param: int = 0


def _value(s: Segment) -> torch.Tensor:
    a, b = s.a, s.b
    if s.op == "sum":
        v = torch.sum(a)
    elif s.op == "dot":
        v = torch.sum(a * b)
    elif s.op == "dot_c":
        v = torch.real(torch.sum(a.conj() * b))
    elif s.op in ("maxabs_c", "maxabs"):
        v = torch.max(torch.abs(a if b is None else a - b))
    elif s.op == "eye":
        p = s.param
        eye = torch.eye(p, dtype=a.dtype, device=a.device)
        v = torch.max(torch.abs(a.reshape(-1, p, p) - eye))
    elif s.op == "herm":
        h = a.reshape(-1, s.param, s.param)
        v = torch.max(torch.abs(h - h.conj().transpose(-1, -2)))
    else:
        v = torch.all(torch.isfinite(a)).to(torch.float64)
    return v * s.scale


def scf_record_plain(segments, nslots: int):
    slots: dict[int, torch.Tensor] = {}
    for s in segments:
        v = _value(s)
        if s.slot not in slots:
            slots[s.slot] = v
        elif OPS[s.op][1] == "sum":
            slots[s.slot] = slots[s.slot] + v
        elif OPS[s.op][1] == "max":
            slots[s.slot] = torch.maximum(slots[s.slot], v)
        else:
            slots[s.slot] = torch.minimum(slots[s.slot], v)
    dev = segments[0].a.device
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    return torch.stack([slots.get(k, zero) for k in range(nslots)])


def _check(segments, nslots: int):
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1..{MAX_SEGMENTS} segments, got {len(segments)}")
    dev = segments[0].a.device
    for s in segments:
        if s.op not in OPS:
            raise ValueError(f"unknown record op '{s.op}'")
        if not 0 <= s.slot < nslots:
            raise ValueError(f"slot {s.slot} outside the [{nslots}] record")
        want = OPS[s.op][2]
        for name, t in (("a", s.a), ("b", s.b)):
            if t is None:
                continue
            if t.dtype != want or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"segment {s.op} -> {s.slot}: {name} must be "
                                 f"contiguous {want} on {dev}")
        if s.op in ("dot", "dot_c") and s.b is None:
            raise ValueError(f"segment {s.op} -> {s.slot} needs b")
        if s.b is not None and s.b.numel() != s.a.numel():
            raise ValueError(f"segment {s.op} -> {s.slot}: a and b differ in "
                             "size")
        if s.op in ("eye", "herm") and (
                s.param < 1 or s.a.numel() % (s.param * s.param)):
            raise ValueError(f"segment {s.op}: {s.a.numel()} values are no "
                             f"stack of {s.param} x {s.param} matrices")
        if s.a.numel() == 0:
            raise ValueError(f"segment {s.op} -> {s.slot} is empty")


def scf_record(segments, nslots: int):
    """The record [nslots] float64 of the segments; see the module
    docstring."""
    _check(segments, nslots)
    dev = segments[0].a.device
    if dev.type == "cpu":
        return scf_record_plain(segments, nslots)
    if dev.type != "cuda":
        raise RuntimeError(f"scf_record: unsupported device {dev}")
    n = len(segments)
    ptrs = np.zeros((n, 3), dtype=np.int64)
    ints = np.zeros((n, 3), dtype=np.int32)
    scales = np.zeros(n, dtype=np.float64)
    for k, s in enumerate(segments):
        ptrs[k] = (s.a.data_ptr(), 0 if s.b is None else s.b.data_ptr(),
                   s.a.numel())
        ints[k] = (OPS[s.op][0], s.slot, s.param)
        scales[k] = s.scale
    partials = torch.empty(_MAX_BLOCKS * n, dtype=torch.float64, device=dev)
    record = torch.empty(nslots, dtype=torch.float64, device=dev)
    rc = build.library("scf_record").scf_record(
        ptrs.ctypes.data, ints.ctypes.data, scales.ctypes.data, n, nslots,
        partials.data_ptr(), record.data_ptr(), build.stream_of(record))
    scf_record.launches += 1
    build.check(rc, "scf_record")
    return record


scf_record.launches = 0
