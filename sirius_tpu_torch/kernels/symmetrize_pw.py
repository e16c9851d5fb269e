"""K6: plane-wave symmetrization over the space group, as a gather
(csrc/symmetrize_pw.cu).

symmetrize_pw(f, millers, lut, rot, trans, dims, sign=None, cosets=None)
returns
  out[g'] = (1/nops) sum_op f[lut[wrap(rot[op] m_g')]]
                          * (e^{-2 pi i m_g' . trans[op]} sign[op])
for f complex128 [ng], the Millers int32 [ng, 3], lut the int32 fine-box ->
G lookup [N] (-1 off the G set), rot the int32 matrices w_k^{-1} [nops, 3, 3]
that take a target Miller to its source, trans float64 [nops, 3] and sign
float64 [nops] (the axial spin sign; None for a scalar field). Replaces
sirius_tpu/dft/density.py::symmetrize_pw_device (:348-358) and its host twin
symmetrize_pw (:155-187). A CPU tensor takes the plain PyTorch version, the
sum over every op; a CUDA tensor launches the kernel, which sums the same
function factorised over the pure translations of the group (cosets, from
build_cosets). The kernel trusts rot, lut and the cosets: the tables are
checked once where they are built (dft/density.py::build_sym_pw_tables).
Launches with a sign (an axial field, the z magnetization and B_z of a
collinear run) are counted apart, on symmetrize_pw.launches_axial.

K6v, symmetrize_vector_pw(f, millers, lut, rot, trans, srot, dims,
cosets=None), is the axial-vector form for f [3, ng] (x, y, z):
  out_i[g'] = (1/nops) sum_op sum_j srot[op, i, j] f_j[lut[wrap(rot[op] m_g')]]
                             * e^{-2 pi i m_g' . trans[op]}
with srot the float64 [nops, 3, 3] rotations det(R) R of an axial vector.
It replaces the host scatter of sirius_tpu/dft/potential_nc.py::
symmetrize_vector_pw (:47-67), with its own launch count.

The factorisation. The pure translations T of the group (the ops whose
rotation is the identity) form a normal subgroup; the ops of one rotation
are a coset {T_j} o rep, with t_op = t_rep + T_j (mod 1) and s_op = s_rep s_j.
They share the source G w^{-1} g', so
  out[g'] = (tau(g') / nops)
            sum_rep s_rep f[w_rep^{-1} g'] e^{-2 pi i m_g' . t_rep}
  tau(g') = sum_j chi_j(g'),  chi_j(g') = s_j e^{-2 pi i m_g' . T_j}
a sum of a character over a group: tau is |T| or 0. The kernel sums the
representatives over the live G (tau = |T|) only and divides by their
count, nops / |T|; every other G is 0. The scalar character (s_j = 1) serves
scalar fields and K6v, whose srot is the identity on every translation; the
axial one (the spin signs) serves axial_z fields. A group without
translations has every G live and every op a representative: the kernel
then sums what it summed before the factorisation, in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
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


# the most representatives a group has: the 48 rotations of m-3m. The
# kernels stage the representatives' tables in shared memory this large.
MAX_REPS = 48
# how far a character sum may sit from 0 or |T|, and two translations
# from each other mod 1
CHARACTER_TOL = 1e-9
TRANSLATION_TOL = 1e-6


@dataclasses.dataclass
class Cosets:
    """The group as the kernels read it: one op of each rotation, in index
    order (rot, trans, sign, srot as the full group's tables), and the G
    where the character sum over the pure translations is |T| (int32
    indices in order): live for scalar fields and K6v, live_axial with the
    translations' spin signs."""

    rot: torch.Tensor  # [nreps, 3, 3] int32
    trans: torch.Tensor  # [nreps, 3] float64
    sign: torch.Tensor  # [nreps] float64
    srot: torch.Tensor  # [nreps, 3, 3] float64
    live: torch.Tensor  # [nlive] int32
    live_axial: torch.Tensor  # [nlive_axial] int32
    num_translations: int

    @property
    def num_reps(self) -> int:
        return self.rot.shape[0]


def factor_translations(rot: np.ndarray, trans: np.ndarray,
                        sign: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(reps, tops): the first op of each rotation class in index order, and
    the ops of the identity class (the pure translations T). Raises
    ValueError, naming the op, unless the identity op is among them, every
    class has |T| ops, each op's t - t_rep is, mod 1, a distinct member of T
    and its spin sign is its representative's times that translation's:
    an op list that fails this is not a group."""
    rot = np.asarray(rot)
    trans = np.asarray(trans, dtype=np.float64)
    sign = np.asarray(sign, dtype=np.float64)
    classes: dict[bytes, list[int]] = {}
    for i in range(rot.shape[0]):
        key = np.ascontiguousarray(rot[i]).tobytes()
        classes.setdefault(key, []).append(i)
    tops = np.asarray(classes.get(np.eye(3, dtype=rot.dtype).tobytes(), []),
                      dtype=np.int64)

    def wrapped(d):
        return np.abs(d - np.rint(d)) < TRANSLATION_TOL

    if not any(wrapped(trans[i]).all() and sign[i] == 1.0 for i in tops):
        raise ValueError("the symmetry ops hold no identity op")
    for members in classes.values():
        rep = members[0]
        if len(members) != len(tops):
            raise ValueError(f"symmetry op {rep}: its rotation has "
                             f"{len(members)} ops, the pure translations "
                             f"{len(tops)}")
        used = set()
        for i in members:
            d = trans[i] - trans[rep] - trans[tops]
            hit = np.nonzero(wrapped(d).all(axis=1))[0]
            if len(hit) != 1 or hit[0] in used:
                raise ValueError(f"symmetry op {i}: t - t of op {rep} is not "
                                 "one pure translation of the group")
            used.add(hit[0])
            if sign[i] != sign[rep] * sign[tops[hit[0]]]:
                raise ValueError(f"symmetry op {i}: spin sign {sign[i]} is "
                                 f"not op {rep}'s times its translation's")
    reps = np.asarray([members[0] for members in classes.values()],
                      dtype=np.int64)
    return reps, tops


def translation_characters(millers: np.ndarray, trans_t: np.ndarray,
                           sign_t: np.ndarray) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """tau(g) = sum_j e^{-2 pi i m_g . T_j} (scalar) and
    sum_j s_j e^{-2 pi i m_g . T_j} (axial) over the pure translations
    T_j with spin signs s_j, float64 [ng] each, rounded to 0 or |T|. Raises
    ValueError where a sum is further than CHARACTER_TOL from both (T is
    then no group, or s no homomorphism on it)."""
    m = np.asarray(millers, dtype=np.float64)
    scalar = np.zeros(m.shape[0], dtype=np.complex128)
    axial = np.zeros_like(scalar)
    for t, s in zip(np.asarray(trans_t, dtype=np.float64), sign_t):
        x = m @ t
        ph = np.exp(-2j * np.pi * (x - np.rint(x)))
        scalar += ph
        axial += s * ph
    nt = len(trans_t)
    out = []
    for name, tau in (("scalar", scalar), ("axial", axial)):
        near = np.where(np.abs(tau) < nt / 2, 0.0, float(nt))
        err = np.abs(tau - near)
        if err.size and err.max() > CHARACTER_TOL:
            g = int(np.argmax(err))
            raise ValueError(f"the {name} character sum over {nt} "
                             f"translations is {tau[g]} at G {g}, not 0 or "
                             f"{nt}")
        out.append(near)
    return out[0], out[1]


def build_cosets(millers, rot, trans, sign, srot, device) -> Cosets:
    """The Cosets of a group given as numpy tables (millers [ng, 3], rot
    the w_k^{-1} [nops, 3, 3], trans [nops, 3], sign [nops], srot [nops, 3,
    3]), on device. Raises ValueError as factor_translations and
    translation_characters do, and where the group has more than MAX_REPS
    rotations."""
    reps, tops = factor_translations(rot, trans, sign)
    if len(reps) > MAX_REPS:
        raise ValueError(f"{len(reps)} rotations, the kernel takes "
                         f"{MAX_REPS}")
    sign = np.asarray(sign, dtype=np.float64)
    scalar, axial = translation_characters(millers, np.asarray(trans)[tops],
                                           sign[tops])

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return Cosets(rot=t(np.asarray(rot)[reps], torch.int32),
                  trans=t(np.asarray(trans)[reps], torch.float64),
                  sign=t(sign[reps], torch.float64),
                  srot=t(np.asarray(srot)[reps], torch.float64),
                  live=t(np.nonzero(scalar)[0], torch.int32),
                  live_axial=t(np.nonzero(axial)[0], torch.int32),
                  num_translations=len(tops))


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
    _check_tables(f, checks)
    if nops < 1:
        raise ValueError("symmetrization needs at least one op")
    if f.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"symmetrize_pw: unsupported device {f.device}")
    return nops, ng, (n1, n2, n3)


def _check_tables(f, checks):
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != f.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {f.device}")


def _check_cosets(f, cosets, live):
    """The kernel's tables: the cosets on f's device, at most MAX_REPS
    representatives, at most ng live G."""
    if cosets is None:
        raise ValueError("on the card K6 sums over the coset representatives:"
                         " pass cosets (build_cosets)")
    nreps = cosets.num_reps
    if not 1 <= nreps <= MAX_REPS:
        raise ValueError(f"{nreps} representatives, the kernel takes 1 to "
                         f"{MAX_REPS}")
    _check_tables(f, (("cosets.rot", cosets.rot, torch.int32, (nreps, 3, 3)),
                      ("cosets.trans", cosets.trans, torch.float64,
                       (nreps, 3)),
                      ("cosets.sign", cosets.sign, torch.float64, (nreps,)),
                      ("cosets.srot", cosets.srot, torch.float64,
                       (nreps, 3, 3)),
                      ("live", live, torch.int32, (live.shape[0],))))
    if live.shape[0] > f.shape[-1]:
        raise ValueError("more live G than G")
    return nreps


def symmetrize_vector_pw(f, millers, lut, rot, trans, srot, dims, cosets=None):
    """K6v: f [3, ng] complex128 (x, y, z) -> its axial-vector average."""
    if f.dtype != torch.complex128 or f.dim() != 2 or f.shape[0] != 3 \
            or not f.is_contiguous():
        raise ValueError("f must be a contiguous complex128 [3, ng] tensor")
    nops, ng, (n1, n2, n3) = _check(f, millers, lut, rot, trans, dims,
                                    (("srot", srot, (3, 3)),))
    if f.device.type == "cpu":
        return symmetrize_vector_pw_plain(f, millers, lut, rot, trans, srot,
                                          (n1, n2, n3))
    live = None if cosets is None else cosets.live
    nreps = _check_cosets(f, cosets, live)
    out = torch.empty_like(f)
    lib = build.library("symmetrize_pw")
    rc = lib.symmetrize_vector_pw(f.data_ptr(), millers.data_ptr(),
                                  live.data_ptr(), live.shape[0],
                                  lut.data_ptr(), cosets.rot.data_ptr(),
                                  cosets.trans.data_ptr(),
                                  cosets.srot.data_ptr(), out.data_ptr(),
                                  nreps, ng, n1, n2, n3, build.stream_of(f))
    symmetrize_vector_pw.launches += 1
    build.check(rc, "symmetrize_vector_pw")
    return out


symmetrize_vector_pw.launches = 0


def symmetrize_pw(f, millers, lut, rot, trans, dims, sign=None, cosets=None):
    if f.dtype != torch.complex128 or f.dim() != 1 or not f.is_contiguous():
        raise ValueError("f must be a contiguous complex128 [ng] tensor")
    nops, ng, (n1, n2, n3) = _check(
        f, millers, lut, rot, trans, dims,
        () if sign is None else (("sign", sign, ()),))
    if f.device.type == "cpu":
        return symmetrize_pw_plain(f, millers, lut, rot, trans, (n1, n2, n3),
                                   sign)
    live = None if cosets is None else (
        cosets.live if sign is None else cosets.live_axial)
    nreps = _check_cosets(f, cosets, live)
    out = torch.empty_like(f)
    lib = build.library("symmetrize_pw")
    rc = lib.symmetrize_pw(f.data_ptr(), millers.data_ptr(), live.data_ptr(),
                           live.shape[0], lut.data_ptr(),
                           cosets.rot.data_ptr(), cosets.trans.data_ptr(),
                           None if sign is None else cosets.sign.data_ptr(),
                           out.data_ptr(), nreps, ng, n1, n2, n3,
                           build.stream_of(f))
    if sign is None:
        symmetrize_pw.launches += 1
    else:
        symmetrize_pw.launches_axial += 1
    build.check(rc, "symmetrize_pw")
    return out


symmetrize_pw.launches = 0
symmetrize_pw.launches_axial = 0
