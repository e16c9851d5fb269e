"""K14a / K14b: the device Anderson mixer of the fused SCF step
(csrc/mixer.cu), and its plain version.

device_mix(hx, hf, count, head, x_in, x_new, w, rms_w, eha_w, beta, kind)
is sirius_tpu/dft/mixer.py::device_mix (:348-414) on a ring of history
rows: hx, hf [m, nx] complex128 hold the pairs (x_in, f) of the last
``count`` steps, row i of the system (oldest first) in slot
(head + i) mod m. It returns (x_mixed [nx], rms, eha), rms and eha 0-d
float64 tensors, and writes (x_in, f) into slot push_slot(count, head, m)
in place; the caller advances count and head on the host
(dft/mixer.py::DeviceMixer), so nothing is read back. kind "linear" mixes
x_in + beta f and pushes the pair; "anderson" solves the m x m system.

A CPU tensor takes the plain version (device_mix_plain: the JAX
expressions over the rows in logical order, torch.linalg.eigh for the
system); a CUDA tensor launches K14a (mixer_gram: the Gram matrix a, the
right-hand side b and rms, two fixed passes) and K14b (mixer_update: the
Jacobi solve in one block, the update with its finite fallback, the ring
push and eha), counted in mixer_gram.launches and mixer_update.launches.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build

MAX_HISTORY = 64  # the solve's one block holds the system in shared memory
KINDS = ("linear", "anderson")
_MAX_BLOCKS = 256  # csrc/mixer.cu kMaxBlocks


def push_slot(count: int, head: int, m: int) -> int:
    """The ring slot the step's pair goes to: the next free one, or the
    oldest once the ring is full."""
    return count if count < m else head


def logical_rows(h, count: int, head: int):
    """The valid rows of a ring [m, nx], oldest first (a view when the ring
    has not wrapped)."""
    if head == 0:
        return h[:count]
    return torch.roll(h, -head, dims=0)[:count]


def _check(hx, hf, count, head, x_in, x_new, w, rms_w, eha_w, kind):
    if kind not in KINDS:
        raise ValueError(f"device mixer supports {KINDS}, got '{kind}'")
    if hx.dim() != 2 or hx.shape != hf.shape:
        raise ValueError("hx and hf must be [m, nx] of one shape")
    m, nx = hx.shape
    if not 1 <= m <= MAX_HISTORY:
        raise ValueError(f"max_history must be 1..{MAX_HISTORY}, got {m}")
    if not (0 <= count <= m and 0 <= head < m and (head == 0 or count == m)):
        raise ValueError(f"ring state count={count} head={head} for m={m}")
    for name, t in (("hx", hx), ("hf", hf), ("x_in", x_in), ("x_new", x_new)):
        if t.dtype != torch.complex128 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous complex128")
    if tuple(x_in.shape) != (nx,) or tuple(x_new.shape) != (nx,):
        raise ValueError(f"x_in and x_new must be [{nx}]")
    for name, t in (("w", w), ("rms_w", rms_w)):
        if t.dtype != torch.float64 or tuple(t.shape) != (nx,):
            raise ValueError(f"{name} must be float64 [{nx}]")
    if eha_w.dtype != torch.float64 or eha_w.dim() != 1 \
            or eha_w.shape[0] > nx:
        raise ValueError("eha_w must be float64 [ng], ng <= nx")
    for t in (hf, x_in, x_new, w, rms_w, eha_w):
        if t.device != hx.device:
            raise ValueError("the mixer's tensors must be on one device")


def mixer_gram_plain(hf, count: int, head: int, x_in, x_new, w, rms_w):
    """K14a's plain version: [m * m + m + 1] float64, a (zero outside the
    first count rows and columns), b and rms, as device_mix computes them
    over its zero-masked [m, nx] block."""
    m = hf.shape[0]
    f = x_new - x_in
    rms = torch.sqrt(torch.clamp(torch.real(torch.sum(rms_w * f.conj() * f)),
                                 min=0.0))
    valid = (torch.arange(m, device=hf.device) < count)[:, None]
    zero = torch.zeros((), dtype=hf.dtype, device=hf.device)
    dfs = torch.where(valid, f[None, :] - torch.roll(hf, -head, dims=0), zero)
    wc = w.to(dfs.dtype)
    a = torch.real(torch.einsum("ix,x,jx->ij", dfs.conj(), wc, dfs))
    b = torch.real(torch.einsum("ix,x,x->i", dfs.conj(), wc, f))
    return torch.cat([a.reshape(-1), b, rms.reshape(1)])


def mixer_update_plain(hx, hf, sys, count: int, head: int, push: int, x_in,
                       x_new, eha_w, beta: float):
    """K14b's plain version: device_mix's eigendecomposition (with its
    a := I and g = 0 rules), update and fallback from the system of
    mixer_gram_plain, the pair pushed into slot push, and eha."""
    m = hx.shape[0]
    f = x_new - x_in
    a = sys[:m * m].reshape(m, m)
    b = sys[m * m:m * m + m]
    valid = (torch.arange(m, device=hx.device) < count)[:, None]
    zero = torch.zeros((), dtype=hx.dtype, device=hx.device)
    dfs = torch.where(valid, f[None, :] - torch.roll(hf, -head, dims=0), zero)
    dxs = torch.where(valid, x_in[None, :] - torch.roll(hx, -head, dims=0),
                      zero)
    ok = torch.all(torch.isfinite(a)) & torch.all(torch.isfinite(b))
    a = torch.where(ok, a, torch.eye(m, dtype=a.dtype, device=a.device))
    ew, v = torch.linalg.eigh(0.5 * (a + a.T))
    thresh = 1e-12 * torch.clamp(ew[-1], min=0.0)
    keep = ew > thresh
    ew_safe = torch.where(keep, ew, torch.ones_like(ew))
    g = v @ (torch.where(keep, 1.0 / ew_safe, torch.zeros_like(ew))
             * (v.T @ b))
    g = torch.where(ok & (count > 0), g, torch.zeros_like(g))
    x_opt = x_in - torch.einsum("i,ix->x", g.to(dxs.dtype), dxs)
    f_opt = f - torch.einsum("i,ix->x", g.to(dfs.dtype), dfs)
    out = x_opt + beta * f_opt
    out = torch.where(torch.all(torch.isfinite(torch.view_as_real(out))),
                      out, x_in + beta * f)
    hx[push] = x_in
    hf[push] = f
    n = eha_w.shape[0]
    d = out[:n] - x_new[:n]
    return out, torch.real(torch.sum(eha_w * d.conj() * d))


def device_mix_plain(hx, hf, count: int, head: int, x_in, x_new, w, rms_w,
                     eha_w, beta: float, kind: str):
    """The JAX package's device_mix on the ring's rows in logical order."""
    m = hx.shape[0]
    push = push_slot(count, head, m)
    if kind == "linear":
        f = x_new - x_in
        rms = torch.sqrt(torch.clamp(
            torch.real(torch.sum(rms_w * f.conj() * f)), min=0.0))
        out = x_in + beta * f
        hx[push] = x_in
        hf[push] = f
        n = eha_w.shape[0]
        d = out[:n] - x_new[:n]
        return out, rms, torch.real(torch.sum(eha_w * d.conj() * d))
    sys = mixer_gram_plain(hf, count, head, x_in, x_new, w, rms_w)
    out, eha = mixer_update_plain(hx, hf, sys, count, head, push, x_in, x_new,
                                  eha_w, beta)
    return out, sys[m * m + m], eha


def mixer_gram(hf, count: int, head: int, x_in, x_new, w, rms_w):
    """K14a: [m * m + m + 1] float64 on the card, the system a [m, m] (the
    first count rows and columns set, zero elsewhere), b [m] and rms. CUDA
    tensors only (the plain version is mixer_gram_plain)."""
    m, nx = hf.shape
    if x_in.device.type != "cuda":
        raise RuntimeError("mixer_gram launches on a CUDA card; the CPU "
                           "takes device_mix_plain")
    nsum = count * (count + 1) // 2 + count + 1
    scratch = torch.empty(_MAX_BLOCKS * nsum, dtype=torch.float64,
                          device=x_in.device)
    out = torch.zeros(m * m + m + 1, dtype=torch.float64, device=x_in.device)
    # (the zero fill keeps the rows and columns past count as the plain
    # version's zero-masked block has them)
    rc = build.library("mixer").mixer_gram(
        x_in.data_ptr(), x_new.data_ptr(), hf.data_ptr(),
        w.contiguous().data_ptr(), rms_w.contiguous().data_ptr(), count, head,
        m, nx, scratch.data_ptr(), out.data_ptr(), build.stream_of(x_in))
    mixer_gram.launches += 1
    build.check(rc, "mixer_gram")
    return out


def mixer_update(hx, hf, sys, count: int, head: int, push: int, x_in, x_new,
                 eha_w, beta: float):
    """K14b: (x_mixed [nx], eha 0-d) from K14a's system over the first
    count rows, with the pair (x_in, f) pushed into ring slot push in
    place. CUDA tensors only (the plain version is mixer_update_plain)."""
    m, nx = hx.shape
    dev = x_in.device
    if dev.type != "cuda":
        raise RuntimeError("mixer_update launches on a CUDA card; the CPU "
                           "takes device_mix_plain")
    out = torch.empty_like(x_in)
    g = torch.empty(m, dtype=torch.float64, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    partials = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=dev)
    eha = torch.empty((), dtype=torch.float64, device=dev)
    rc = build.library("mixer").mixer_update(
        x_in.data_ptr(), x_new.data_ptr(), hx.data_ptr(), hf.data_ptr(),
        sys.data_ptr(), count, head, m, push, nx,
        eha_w.shape[0], float(beta), eha_w.contiguous().data_ptr(),
        out.data_ptr(), g.data_ptr(), flag.data_ptr(), partials.data_ptr(),
        eha.data_ptr(), build.stream_of(x_in))
    mixer_update.launches += 1
    build.check(rc, "mixer_update")
    return out, eha


def device_mix(hx, hf, count: int, head: int, x_in, x_new, w, rms_w, eha_w,
               beta: float, kind: str):
    """One mixer step; see the module docstring. Returns (x_mixed, rms,
    eha) and pushes (x_in, x_new - x_in) into the ring in place."""
    _check(hx, hf, count, head, x_in, x_new, w, rms_w, eha_w, kind)
    if x_in.device.type == "cpu":
        return device_mix_plain(hx, hf, count, head, x_in, x_new, w, rms_w,
                                eha_w, beta, kind)
    if x_in.device.type != "cuda":
        raise RuntimeError(f"device_mix: unsupported device {x_in.device}")
    cnt = 0 if kind == "linear" else count
    m = hx.shape[0]
    sys = mixer_gram(hf, cnt, head, x_in, x_new, w, rms_w)
    out, eha = mixer_update(hx, hf, sys, cnt, head, push_slot(count, head, m),
                            x_in, x_new, eha_w, beta)
    return out, sys[m * m + m], eha


mixer_gram.launches = 0
mixer_update.launches = 0
