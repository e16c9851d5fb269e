"""K6: plane-wave symmetrization over the space group, as a gather
(csrc/symmetrize_pw.cu).

symmetrize_pw(f, millers, lut, rot, trans, dims, sign=None) returns
  out[g'] = (1/nops) sum_op f[lut[wrap(rot[op] m_g')]]
                          * (e^{-2 pi i m_g' . trans[op]} sign[op])
for f complex128 [ng], the Millers int32 [ng, 3], lut the int32 fine-box ->
G lookup [N] (-1 off the G set), rot the int32 matrices w_k^{-1} [nops, 3, 3]
that take a target Miller to its source, trans float64 [nops, 3] and sign
float64 [nops] (the axial spin sign; None for a scalar field). Replaces
sirius_tpu/dft/density.py::symmetrize_pw_device (:348-358) and its host twin
symmetrize_pw (:155-187). A CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel. The kernel trusts rot and lut: the tables
are checked once where they are built (dft/density.py::build_sym_pw_tables).
Launches with a sign (an axial field, the z magnetization and B_z of a
collinear run) are counted apart, on symmetrize_pw.launches_axial.

K6v, symmetrize_vector_pw(f, millers, lut, rot, trans, srot, dims), is the
axial-vector form for f [3, ng] (x, y, z):
  out_i[g'] = (1/nops) sum_op sum_j srot[op, i, j] f_j[lut[wrap(rot[op] m_g')]]
                             * e^{-2 pi i m_g' . trans[op]}
with srot the float64 [nops, 3, 3] rotations det(R) R of an axial vector.
It replaces the host scatter of sirius_tpu/dft/potential_nc.py::
symmetrize_vector_pw (:47-67), with its own launch count.
"""

from __future__ import annotations

import math

import torch

from sirius_tpu_torch.kernels import build


def source_index(m, rot, lut, dims):
    """The source G of every target under one op: lut at the wrapped
    rotated Miller index (-1 off the G set), and that Miller index. m the
    int64 Millers [ng, 3], rot one [3, 3] matrix."""
    n1, n2, n3 = dims
    src = (m[:, None, :] * rot.long()[None]).sum(-1)
    lin = ((src[:, 0] % n1) * n2 + src[:, 1] % n2) * n3 + src[:, 2] % n3
    return lut[lin].long(), src


def symmetrize_pw_plain(f, millers, lut, rot, trans, dims, sign=None):
    m = millers.long()
    mf = millers.to(torch.float64)
    out = torch.zeros_like(f)
    for op in range(rot.shape[0]):
        g, _ = source_index(m, rot[op], lut, dims)
        t = trans[op]
        x = mf[:, 0] * t[0] + mf[:, 1] * t[1] + mf[:, 2] * t[2]
        x = x - torch.round(x)
        phase = torch.polar(torch.ones_like(x), -2.0 * math.pi * x)
        if sign is not None:
            phase = phase * sign[op]
        out += f[g] * phase
    return out / rot.shape[0]


def symmetrize_vector_pw_plain(f, millers, lut, rot, trans, srot, dims):
    m = millers.long()
    mf = millers.to(torch.float64)
    out = torch.zeros_like(f)
    for op in range(rot.shape[0]):
        g, _ = source_index(m, rot[op], lut, dims)
        t = trans[op]
        x = mf[:, 0] * t[0] + mf[:, 1] * t[1] + mf[:, 2] * t[2]
        x = x - torch.round(x)
        phase = torch.polar(torch.ones_like(x), -2.0 * math.pi * x)
        out += (srot[op].to(f.dtype) @ f[:, g]) * phase
    return out / rot.shape[0]


def _check(f, millers, lut, rot, trans, dims, extra=()):
    """Validate the tables against f [..., ng]; returns (nops, ng, dims)."""
    ng = f.shape[-1]
    nops = rot.shape[0]
    n1, n2, n3 = (int(x) for x in dims)
    checks = (("millers", millers, torch.int32, (ng, 3)),
              ("lut", lut, torch.int32, (n1 * n2 * n3,)),
              ("rot", rot, torch.int32, (nops, 3, 3)),
              ("trans", trans, torch.float64, (nops, 3))) + tuple(
        (name, t, torch.float64, (nops,) + shape) for name, t, shape in extra)
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != f.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {f.device}")
    if nops < 1:
        raise ValueError("symmetrization needs at least one op")
    if f.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"symmetrize_pw: unsupported device {f.device}")
    return nops, ng, (n1, n2, n3)


def symmetrize_vector_pw(f, millers, lut, rot, trans, srot, dims):
    """K6v: f [3, ng] complex128 (x, y, z) -> its axial-vector average."""
    if f.dtype != torch.complex128 or f.dim() != 2 or f.shape[0] != 3 \
            or not f.is_contiguous():
        raise ValueError("f must be a contiguous complex128 [3, ng] tensor")
    nops, ng, (n1, n2, n3) = _check(f, millers, lut, rot, trans, dims,
                                    (("srot", srot, (3, 3)),))
    if f.device.type == "cpu":
        return symmetrize_vector_pw_plain(f, millers, lut, rot, trans, srot,
                                          (n1, n2, n3))
    out = torch.empty_like(f)
    lib = build.library("symmetrize_pw")
    rc = lib.symmetrize_vector_pw(f.data_ptr(), millers.data_ptr(),
                                  lut.data_ptr(), rot.data_ptr(),
                                  trans.data_ptr(), srot.data_ptr(),
                                  out.data_ptr(), nops, ng, n1, n2, n3,
                                  build.stream_of(f))
    symmetrize_vector_pw.launches += 1
    build.check(rc, "symmetrize_vector_pw")
    return out


symmetrize_vector_pw.launches = 0


def symmetrize_pw(f, millers, lut, rot, trans, dims, sign=None):
    if f.dtype != torch.complex128 or f.dim() != 1 or not f.is_contiguous():
        raise ValueError("f must be a contiguous complex128 [ng] tensor")
    nops, ng, (n1, n2, n3) = _check(
        f, millers, lut, rot, trans, dims,
        () if sign is None else (("sign", sign, ()),))
    if f.device.type == "cpu":
        return symmetrize_pw_plain(f, millers, lut, rot, trans, (n1, n2, n3),
                                   sign)
    out = torch.empty_like(f)
    lib = build.library("symmetrize_pw")
    rc = lib.symmetrize_pw(f.data_ptr(), millers.data_ptr(), lut.data_ptr(),
                           rot.data_ptr(), trans.data_ptr(),
                           None if sign is None else sign.data_ptr(),
                           out.data_ptr(), nops, ng, n1, n2, n3,
                           build.stream_of(f))
    if sign is None:
        symmetrize_pw.launches += 1
    else:
        symmetrize_pw.launches_axial += 1
    build.check(rc, "symmetrize_pw")
    return out


symmetrize_pw.launches = 0
symmetrize_pw.launches_axial = 0
