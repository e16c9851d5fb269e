"""K4 and K5: the ultrasoft augmentation charge and the D operator of one
atom type, with the structure-factor phases generated on the fly
(csrc/augmentation.cu).

  rho_aug(dm, gidx, w, millers, pos, q, out=None, pairs=None)
      out[s, g] (+)= sum_a sum_q e^{-2 pi i m_g . tau_a}
                                w_q Re(dm[s].flat[gidx[a, q]]) q[q, g]
  d_operator(v, millers, pos, q, gidx, lo_idx, lo_mask, omega, d)
      vq[c, a, q] = omega Re sum_g q[q, g] conj(v[c, g]) e^{-2 pi i m_g . tau_a}
      d[c].flat[gidx] += vq[c]; d[c].flat[lo_idx] += vq[c] * lo_mask
      (in place, every channel c of v [nch, ng] and d [nch, nbeta, nbeta]
      in one launch)

Replace sirius_tpu/ops/augmentation.py::rho_aug_g_device (:250-263) and
d_operator_device (:266-282) for one type. A CPU tensor takes the plain
PyTorch versions below (dense phases, einsum); a CUDA tensor launches the
kernels. K4 sums each (G, -G) row of ``pairs`` (gvec_pairs) once, in one
launch sized by rho_aug_plan; K5 launches groups of atoms that fit its
shared memory and register tiles (d_operator_plan); both plans are pure
functions of the shape, tested on the CPU. The kernels trust gidx, lo_idx
and pairs: ops/augmentation.py::build_aug_device_tables checks the first
two against D once and holds the third, gvec_pairs of the Millers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sirius_tpu_torch.kernels import build

THREADS = 256
SHARED_MAX = 227 * 1024  # dynamic shared memory a block can opt in to
SHARED_SM = 228 * 1024  # an SM's shared memory (1 KB of it reserved a block)
THREADS_SM = 2048  # resident threads an SM
# K4 (csrc/augmentation.cu): the row tiles the plan tries (largest first;
# a block is ns x ksplit x tg threads, at most RA_MAX_THREADS)
RA_TILES = (128, 64, 32)
RA_MAX_THREADS = 512
RA_REGS = 128  # registers a thread at most: the launch bound's 65,536 / 512
RA_BLOCK = 128  # the threads of a block the plan aims at
RA_MIN_RESIDENT = 256  # resident threads an SM below which q is split
# K5 pass 1 (csrc/augmentation.cu): a thread's register tile of TM
# (channel, atom) rows by TN q, the cp.async pipeline's depth, the G tiles
# the plan tries (largest first; each divides THREADS) and the resident
# blocks an SM (__launch_bounds__(THREADS, 3))
TM, TN = 4, 5
STAGES = 3
G_TILES = (32, 16)
BLOCKS_PER_SM = 3


def structure_phases(millers, pos):
    """e^{-2 pi i m_g . tau_a} as [ng, na] complex128, the argument
    m0 t0 + m1 t1 + m2 t2 reduced to [-1/2, 1/2] before the exponential."""
    m = millers.to(torch.float64)
    x = (m[:, None, 0] * pos[None, :, 0] + m[:, None, 1] * pos[None, :, 1]
         + m[:, None, 2] * pos[None, :, 2])
    x = x - torch.round(x)
    return torch.polar(torch.ones_like(x), -2.0 * math.pi * x)


def rho_aug_plain(dm, gidx, w, millers, pos, q):
    ns = dm.shape[0]
    dmp = w[None, None, :] * dm.reshape(ns, -1)[:, gidx.long()].real
    ph = structure_phases(millers, pos)
    return torch.einsum("ga,saq,qg->sg", ph, dmp.to(ph.dtype), q)


def d_operator_plain(v, millers, pos, q, gidx, lo_idx, lo_mask, omega, d):
    ph = structure_phases(millers, pos)
    flat = d.view(d.shape[0], -1)
    for c, vc in enumerate(v):
        vq = omega * torch.einsum("qg,g,ga->aq", q, vc.conj(), ph).real
        flat[c].index_add_(0, gidx.reshape(-1).long(), vq.reshape(-1))
        flat[c].index_add_(0, lo_idx.reshape(-1).long(),
                           (vq * lo_mask[None, :]).reshape(-1))
    return d


def d_operator_layout(na: int, nqlm: int, nch: int, tg: int) -> dict:
    """K5 pass 1's shared memory in bytes, as csrc/augmentation.cu's
    dop_layout counts it, and its output tiles (TM x TN register tiles
    over the padded (channel, atom) rows and q)."""
    tgp = tg + 1
    npad = -(-nqlm // TN) * TN
    mpad = -(-(nch * na) // TM) * TM
    stage = npad * tgp * 16 + nch * tg * 16 + tg * 12
    z_off = max(STAGES * stage, THREADS * TM * TN * 8)
    total = z_off + mpad * tgp * 16 + -(-(na * 24) // 16) * 16
    return {"shared": total, "out_tiles": (mpad // TM) * (npad // TN)}


def _largest_group(na: int, nqlm: int, nch: int, tg: int) -> int:
    """The most atoms one launch takes at G tile tg (0: not even one)."""
    for group in range(na, 0, -1):
        lay = d_operator_layout(group, nqlm, nch, tg)
        if lay["out_tiles"] <= THREADS and lay["shared"] <= SHARED_MAX:
            return group
    return 0


@functools.lru_cache(maxsize=None)
def d_operator_plan(na: int, nqlm: int, nch: int, ng: int,
                    sm_count: int) -> dict:
    """K5's launch plan: the G tile tg, the atoms of a launch (group; the
    type takes ngroups launches), the G chunk of a pass-1 block and the
    number of blocks (the chunks cover [0, ng) once, chunk a multiple of
    tg), the first group's shared memory, output tiles and the threads
    splitting each tile's G (lanes), and the resident blocks an SM. It
    prefers the fewest launches (each streams Q once), then two resident
    blocks an SM or more, then the larger tile, then a third resident
    block. The summation order, hence D's last bits, follows
    this plan: it is a function of the shape and the card's SM count."""
    options = []
    for tg in G_TILES:
        group = _largest_group(na, nqlm, nch, tg)
        if group:
            lay = d_operator_layout(group, nqlm, nch, tg)
            bps = max(1, min(BLOCKS_PER_SM,
                             SHARED_SM // (lay["shared"] + 1024)))
            options.append(((-(-na // group), -min(bps, 2), -tg, -bps), tg,
                            group, bps, lay))
    if not options:
        raise ValueError(f"d_operator: nqlm = {nqlm} with {nch} channels "
                         "does not fit the kernel")
    _, tg, group, bps, lay = min(options, key=lambda o: o[0])
    tiles = -(-ng // tg)
    chunk = max(1, -(-tiles // (sm_count * bps))) * tg
    return {"tg": tg, "group": group, "ngroups": -(-na // group),
            "chunk": chunk, "nblocks": -(-ng // chunk),
            "shared": lay["shared"], "out_tiles": lay["out_tiles"],
            "lanes": THREADS // lay["out_tiles"], "blocks_per_sm": bps}


def rho_aug_layout(ns: int, nqlm: int, tg: int, atoms: int,
                   ksplit: int = 1) -> int:
    """K4's shared memory in bytes, as csrc/augmentation.cu's ra_layout
    counts it: the packed coefficients [ns, atoms, nqlm], the positions
    [atoms, 3], one atom tile's phases [atoms, tg] (sin, cos) and, with
    ksplit 2, the upper q half's atom sums [ns, nqlm - nqlm // 2, tg]."""
    tau_off = -(-(ns * atoms * nqlm * 8) // 16) * 16
    ph_off = tau_off + -(-(atoms * 24) // 16) * 16
    return ph_off + atoms * tg * 16 + ns * (nqlm - nqlm // ksplit) * tg * 16


def _most_atoms(na: int, nqlm: int, ns: int, tg: int) -> int:
    """The most atoms (at most na) one tile of K4 stages at row tile tg
    (0: not even one)."""
    atoms = min(na, SHARED_MAX // (ns * nqlm * 8 + 24 + tg * 16))
    while atoms > 0 and rho_aug_layout(ns, nqlm, tg, atoms) > SHARED_MAX:
        atoms -= 1
    return atoms


def _resident_threads(threads: int, shared: int) -> int:
    """K4's threads resident an SM, as shared memory, threads and registers
    (at most RA_REGS a thread) allow."""
    blocks = min(SHARED_SM // (shared + 1024), 32, THREADS_SM // threads,
                 65536 // RA_REGS // threads)
    return blocks * threads


@functools.lru_cache(maxsize=None)
def rho_aug_plan(na: int, nqlm: int, ns: int, nrow: int) -> dict:
    """K4's launch plan: the row tile tg, the threads a row's channel
    splits its q over (ksplit), the atoms a tile of shared memory holds
    (atom_tiles of them cover the type, summed in one chain; with one, each
    row's phases are computed once per atom), its shared memory, the row
    tiles and the threads resident an SM. A block is ns x ksplit x tg
    threads, RA_BLOCK where the tiles allow (the fastest or as fast as any
    at every shape of tools/torch_port_k4.py --plans on the H100); a
    smaller row tile where it takes fewer atom tiles. The q split (ksplit
    2) is taken only where one atom tile holds the type and shared memory
    leaves fewer than RA_MIN_RESIDENT threads an SM without it (the
    54-atom cell on one channel): elsewhere its second pass over the
    phases cost more than its threads gained. The launch takes the
    resident blocks of the card (csrc/augmentation.cu asks the occupancy
    of the compiled kernel). Raises ValueError where not one atom fits (ns
    nqlm near 29,000)."""

    def option(ksplit):
        top = min(RA_TILES[0], max(RA_TILES[-1], RA_BLOCK // (ns * ksplit)))
        best = None
        for tg in (t for t in RA_TILES if t <= top):
            atoms = _most_atoms(na, nqlm, ns, tg)
            shared = rho_aug_layout(ns, nqlm, tg, atoms, ksplit)
            if not atoms or shared > SHARED_MAX \
                    or ns * ksplit * tg > RA_MAX_THREADS:
                continue
            tiles = -(-na // atoms)
            if ksplit > 1 and tiles > 1:
                continue
            if best is None or tiles < best["atom_tiles"]:
                best = {"tg": tg, "ksplit": ksplit,
                        "threads": ns * ksplit * tg, "atoms": atoms,
                        "atom_tiles": tiles, "shared": shared,
                        "row_tiles": -(-nrow // tg),
                        "resident_threads": _resident_threads(
                            ns * ksplit * tg, shared)}
        return best

    plan = option(1)
    if plan is None:
        raise ValueError(f"rho_aug: {ns} channels of nqlm = {nqlm} do not "
                         "fit the kernel's shared memory")
    if nqlm > 1 and plan["atom_tiles"] == 1 \
            and plan["resident_threads"] < RA_MIN_RESIDENT:
        split = option(2)
        if split is not None \
                and split["resident_threads"] > plan["resident_threads"]:
            plan = split
    return plan


def gvec_pairs(millers, device=None) -> torch.Tensor:
    """K4's rows: int32 [npair, 2], (g, the index of -G) for every g whose
    partner's index is not smaller (G = 0: (g, g)), in the order of g, on
    device (by default the Millers'; millers int [ng, 3], a tensor or an
    array), built on the host. Every G lies in exactly one row. Raises
    ValueError if two G share Millers or some G's -G is missing."""
    if device is None:
        device = (millers.device if isinstance(millers, torch.Tensor)
                  else "cpu")
    m = np.asarray(millers.cpu() if isinstance(millers, torch.Tensor)
                   else millers, dtype=np.int64).reshape(-1, 3)
    ng = m.shape[0]
    off = int(np.abs(m).max()) if ng else 0
    base = 2 * off + 1

    def key(x):
        return ((x[:, 0] + off) * base + x[:, 1] + off) * base + x[:, 2] + off

    k = key(m)
    order = np.argsort(k, kind="stable")
    ks = k[order]
    if ng and bool((ks[1:] == ks[:-1]).any()):
        raise ValueError("gvec_pairs: two G share their Millers")
    at = np.minimum(np.searchsorted(ks, key(-m)), max(ng - 1, 0))
    found = ks[at] == key(-m) if ng else np.zeros(0, dtype=bool)
    if not found.all():
        bad = int(np.nonzero(~found)[0][0])
        raise ValueError(f"gvec_pairs: {int((~found).sum())} G have no -G "
                         f"in the set (the first: Millers {m[bad].tolist()})")
    partner = order[at]
    rep = np.nonzero(partner >= np.arange(ng))[0]
    rows = np.stack([rep, partner[rep]], axis=1).astype(np.int32)
    return torch.as_tensor(rows.reshape(-1, 2), device=device)


def phase_check(millers, pos, pairs) -> dict:
    """On the card: whether the phase of -G is the conjugate of G's bit
    for bit for every row of pairs and atom of pos, as K4 evaluates them
    (csrc/augmentation.cu rho_aug_phase_check). Counts of (row, atom)
    arguments: checked, and arguments, sines and cosines that differ
    otherwise and only in a zero's sign."""
    if millers.device.type != "cuda":
        raise RuntimeError("phase_check runs on a CUDA card")
    counts = torch.zeros(7, dtype=torch.int64, device=millers.device)
    pos = pos.contiguous()
    rc = build.library("augmentation").rho_aug_phase_check(
        millers.data_ptr(), pos.data_ptr(), pairs.data_ptr(), pairs.shape[0],
        pos.shape[0], counts.data_ptr(), build.stream_of(millers))
    build.check(rc, "rho_aug_phase_check")
    c = [int(x) for x in counts.cpu()]
    return {"checked": c[0], "argument_differs": c[1],
            "argument_zero_sign": c[2], "sin_differs": c[3],
            "sin_zero_sign": c[4], "cos_differs": c[5], "cos_zero_sign": c[6]}


_PARTIAL: dict = {}


def _partial(device, numel: int):
    """K5's pass-1 partial sums: one float64 buffer a device, kept across
    calls and grown to the largest plan seen (the launches that share it run
    in order on one stream)."""
    buf = _PARTIAL.get(device)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(max(numel, 1), dtype=torch.float64, device=device)
        _PARTIAL[device] = buf
    return buf


def _check_type(millers, pos, q, gidx, device):
    ng, nqlm, na = millers.shape[0], q.shape[0], pos.shape[0]
    if millers.dtype != torch.int32 or tuple(millers.shape) != (ng, 3):
        raise ValueError("millers must be int32 [ng, 3]")
    if pos.dtype != torch.float64 or tuple(pos.shape) != (na, 3):
        raise ValueError("pos must be float64 [na, 3]")
    if q.dtype != torch.complex128 or tuple(q.shape) != (nqlm, ng):
        raise ValueError(f"q must be complex128 [nqlm, ng={ng}]")
    if gidx.dtype != torch.int32 or tuple(gidx.shape) != (na, nqlm):
        raise ValueError(f"gidx must be int32 [na={na}, nqlm={nqlm}]")
    for name, t in (("millers", millers), ("pos", pos), ("q", q),
                    ("gidx", gidx)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ng, nqlm, na


def rho_aug(dm, gidx, w, millers, pos, q, out=None, pairs=None):
    """One type's augmentation charge [ns, ng]; added into ``out`` when it
    is given (the sum over types), else returned as a new tensor. On a
    CUDA tensor ``pairs`` (gvec_pairs of the Millers) is required."""
    if dm.dtype != torch.complex128 or dm.dim() != 3 \
            or dm.shape[0] not in (1, 2, 4) or dm.shape[1] != dm.shape[2] \
            or not dm.is_contiguous():
        raise ValueError("dm must be a contiguous complex128 [ns, nbeta, nbeta]"
                         " tensor, ns 1, 2 or 4")
    ns, nbeta = dm.shape[0], dm.shape[1]
    ng, nqlm, na = _check_type(millers, pos, q, gidx, dm.device)
    if w.dtype != torch.float64 or tuple(w.shape) != (nqlm,) \
            or w.device != dm.device:
        raise ValueError("w must be float64 [nqlm] on dm's device")
    if out is not None and (out.dtype != torch.complex128
                            or tuple(out.shape) != (ns, ng)
                            or not out.is_contiguous()
                            or out.device != dm.device):
        raise ValueError(f"out must be a contiguous complex128 [{ns}, {ng}]")
    if pairs is not None and (pairs.dtype != torch.int32 or pairs.dim() != 2
                              or pairs.shape[1] != 2
                              or not ng / 2 <= pairs.shape[0] <= ng
                              or not pairs.is_contiguous()
                              or pairs.device != dm.device):
        raise ValueError(f"pairs must be contiguous int32 [npair, 2] on dm's "
                         f"device, gvec_pairs of the {ng} Millers")
    if dm.device.type == "cpu":
        res = rho_aug_plain(dm, gidx, w, millers, pos, q)
        if out is None:
            return res
        out += res
        return out
    if dm.device.type != "cuda":
        raise RuntimeError(f"rho_aug: unsupported device {dm.device}")
    if pairs is None:
        raise ValueError("rho_aug: a CUDA launch needs pairs= "
                         "(gvec_pairs(millers))")
    accumulate = out is not None
    if na == 0 or ng == 0:
        return out if accumulate else torch.zeros(
            (ns, ng), dtype=torch.complex128, device=dm.device)
    if out is None:
        out = torch.empty((ns, ng), dtype=torch.complex128, device=dm.device)
    nrow = pairs.shape[0]
    plan = rho_aug_plan(na, nqlm, ns, nrow)
    w = w.contiguous()
    rc = build.library("augmentation").rho_aug(
        dm.data_ptr(), gidx.data_ptr(), w.data_ptr(), millers.data_ptr(),
        pos.data_ptr(), pairs.data_ptr(), q.data_ptr(), out.data_ptr(), ns,
        nbeta * nbeta, na, nqlm, ng, nrow, plan["tg"], plan["atoms"],
        plan["ksplit"], int(accumulate), build.stream_of(dm))
    build.check(rc, "rho_aug")
    rho_aug.launches += 1
    return out


rho_aug.launches = 0


def d_operator(v, millers, pos, q, gidx, lo_idx, lo_mask, omega: float, d):
    """Add one type's augmentation term to the real D of every channel in
    place and return d: v complex128 [nch, ng], d float64
    [nch, nbeta, nbeta]."""
    if v.dtype != torch.complex128 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError("v must be a contiguous complex128 [nch, ng] tensor")
    ng, nqlm, na = _check_type(millers, pos, q, gidx, v.device)
    nch = v.shape[0]
    if v.shape[1] != ng or nch < 1:
        raise ValueError(f"v must be [nch, {ng}], got {tuple(v.shape)}")
    if lo_idx.dtype != torch.int32 or lo_idx.shape != gidx.shape \
            or not lo_idx.is_contiguous() or lo_idx.device != v.device:
        raise ValueError("lo_idx must be contiguous int32 with gidx's shape")
    if lo_mask.dtype != torch.float64 or tuple(lo_mask.shape) != (nqlm,) \
            or lo_mask.device != v.device:
        raise ValueError("lo_mask must be float64 [nqlm] on v's device")
    if d.dtype != torch.float64 or d.dim() != 3 or d.shape[0] != nch \
            or d.shape[1] != d.shape[2] or not d.is_contiguous() \
            or d.device != v.device:
        raise ValueError(f"d must be a contiguous float64 [{nch}, nbeta, "
                         "nbeta] tensor")
    if v.device.type == "cpu":
        return d_operator_plain(v, millers, pos, q, gidx, lo_idx, lo_mask,
                                omega, d)
    if v.device.type != "cuda":
        raise RuntimeError(f"d_operator: unsupported device {v.device}")
    if na == 0:
        return d
    if millers.data_ptr() % 16:
        # pass 1 copies the Millers in 16-byte runs
        raise ValueError("millers must start on a 16-byte boundary")
    plan = d_operator_plan(na, nqlm, nch, ng, build.sm_count(v.device))
    group, nblocks = plan["group"], plan["nblocks"]
    partial = _partial(v.device, nblocks * nch * min(group, na) * nqlm)
    lo_mask = lo_mask.contiguous()
    nbeta = d.shape[-1]
    lib = build.library("augmentation")
    stream = build.stream_of(v)
    for a0 in range(0, na, group):
        sl = slice(a0, a0 + group)
        g_pos = pos[sl]
        rc = lib.d_operator(millers.data_ptr(), g_pos.data_ptr(), q.data_ptr(),
                            v.data_ptr(), partial.data_ptr(), nblocks,
                            plan["chunk"], plan["tg"], gidx[sl].data_ptr(),
                            lo_idx[sl].data_ptr(), lo_mask.data_ptr(),
                            float(omega), d.data_ptr(), nch, g_pos.shape[0],
                            nqlm, ng, nbeta * nbeta, stream)
        build.check(rc, "d_operator")
    d_operator.launches += 1
    return d


d_operator.launches = 0
