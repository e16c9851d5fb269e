"""K4 and K5: the ultrasoft augmentation charge and the D operator of one
atom type, with the structure-factor phases generated on the fly
(csrc/augmentation.cu).

  rho_aug(dm, gidx, w, millers, pos, q, out=None)
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
kernels. Large types are launched in groups of atoms that fit the
kernels' shared memory and register tiles (K5: d_operator_plan, a pure
function of the shape, tested on the CPU). The kernels trust gidx and
lo_idx: ops/augmentation.py::build_aug_device_tables checks them against D
once.
"""

from __future__ import annotations

import functools
import math

import torch

from sirius_tpu_torch.kernels import build

THREADS = 256
SHARED_MAX = 227 * 1024  # dynamic shared memory a block can opt in to
SHARED_SM = 228 * 1024  # an SM's shared memory (1 KB of it reserved a block)
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


def rho_aug(dm, gidx, w, millers, pos, q, out=None):
    """One type's augmentation charge [ns, ng]; added into ``out`` when it
    is given (the sum over types), else returned as a new tensor."""
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
    if dm.device.type == "cpu":
        res = rho_aug_plain(dm, gidx, w, millers, pos, q)
        if out is None:
            return res
        out += res
        return out
    if dm.device.type != "cuda":
        raise RuntimeError(f"rho_aug: unsupported device {dm.device}")
    group = SHARED_MAX // (8 * (ns * nqlm + 3))
    if group < 1:
        raise ValueError(f"rho_aug: nqlm = {nqlm} does not fit shared memory")
    accumulate = out is not None
    if na == 0:
        return out if accumulate else torch.zeros(
            (ns, ng), dtype=torch.complex128, device=dm.device)
    if out is None:
        out = torch.empty((ns, ng), dtype=torch.complex128, device=dm.device)
    lib = build.library("augmentation")
    stream = build.stream_of(dm)
    w = w.contiguous()
    for a0 in range(0, na, group):
        g_idx, g_pos = gidx[a0:a0 + group], pos[a0:a0 + group]
        rc = lib.rho_aug(dm.data_ptr(), g_idx.data_ptr(), w.data_ptr(),
                         millers.data_ptr(), g_pos.data_ptr(), q.data_ptr(),
                         out.data_ptr(), ns, nbeta * nbeta, g_pos.shape[0],
                         nqlm, ng, int(accumulate), stream)
        build.check(rc, "rho_aug")
        accumulate = True
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
