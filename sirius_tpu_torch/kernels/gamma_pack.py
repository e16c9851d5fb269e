"""K8: the Gamma packed-real layout around the FFTs (csrc/gamma_pack.cu).

Two entry points, each a wrapper that launches the CUDA kernel for a CUDA
tensor and takes the plain PyTorch version below for a CPU tensor:

  unpack_to_box(x, mask_p, slot_re, slot_im, im_sign, scale, fft_index, nbox)
      packed real x [B, R, ngk] -> complex box [B, R, nbox]: zero fill, then
      c = scale * x'[slot_re] + i * (scale * im_sign) * x'[slot_im] with
      x' = x * mask_p, stored at fft_index for every sphere lane with
      scale != 0 (padded lanes carry scale 0 and point at the G = 0 slot);
  box_to_packed_hx(vbox, x, ekin_p, mask_p, rep_box, par_box, zero_box)
      transformed box [B, R, nbox] -> (hx, sx) [B, R, ngk] float64:
      vpack[0] = Re v[zero_box], vpack[1 + k] = h Re v[rep_box[k]] +
      h Re v[par_box[k]], vpack[1 + P + k] = h Im v[rep_box[k]] -
      h Im v[par_box[k]] (h = sqrt2 / 2), 0 past 1 + 2P;
      hx = (where(mask_p > 0, ekin_p, 0) * x' + vpack) * mask_p, sx = x' * mask_p.

The lane tables are [ngk] (one Gamma sphere); rep_box / par_box [P] are the
box positions of each pair's two members; K8b's kernel takes one thread
a pair and PACK_ROWS rows a thread (pack_plan). Replaces
sirius_tpu/ops/gamma.py::apply_h_s_gamma (:216-226, :230-245) and
_pack_device (:248-268).

Two instantiations: float64 packed blocks with complex128 boxes and float64
tables (counted in <wrapper>.launches), and float32 packed blocks with
complex64 boxes and float32 tables (the fp32 wave-function path,
<wrapper>.launches_f32).
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build

# sqrt(2) / 2 as the JAX package rounds it (float(0.5 * np.sqrt(2.0)))
HALF_SQRT2 = 0.7071067811865476


def _check_packed(name, t):
    if t.dtype not in (torch.float64, torch.float32) or t.dim() != 3:
        raise ValueError(f"{name} must be float64 or float32 [B, rows, ngk], "
                         f"got {t.dtype} {tuple(t.shape)}")


def _complex_of(real):
    return torch.complex128 if real == torch.float64 else torch.complex64


def _check_tables(ngk, device, real, **tables):
    for name, t in tables.items():
        want = torch.int32 if name in ("slot_re", "slot_im", "fft_index",
                                       "rep_box", "par_box") else real
        if t.dtype != want or t.dim() != 1:
            raise ValueError(f"{name} must be a {want} vector, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if name not in ("rep_box", "par_box") and t.shape[0] != ngk:
            raise ValueError(f"{name} has {t.shape[0]} lanes, want {ngk}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def unpack_to_box_plain(x, mask_p, slot_re, slot_im, im_sign, scale,
                        fft_index, nbox):
    b, r, _ = x.shape
    xm = x * mask_p
    xr = xm[..., slot_re.long()]
    xi = xm[..., slot_im.long()]
    c = torch.complex(scale * xr, scale * im_sign * xi)
    valid = scale != 0
    box = torch.zeros((b, r, nbox), dtype=_complex_of(x.dtype),
                      device=x.device)
    box[..., fft_index.long()[valid]] = c[..., valid]
    return box


def unpack_to_box(x, mask_p, slot_re, slot_im, im_sign, scale, fft_index,
                  nbox: int):
    """Unpack a packed-real block [B, R, ngk] into a zeroed complex box
    [B, R, nbox]."""
    _check_packed("x", x)
    _, suffix = build.variant(x.dtype)
    b, r, ngk = x.shape
    _check_tables(ngk, x.device, x.dtype, mask_p=mask_p, slot_re=slot_re,
                  slot_im=slot_im, im_sign=im_sign, scale=scale,
                  fft_index=fft_index)
    if x.device.type == "cpu":
        return unpack_to_box_plain(x, mask_p, slot_re, slot_im, im_sign,
                                   scale, fft_index, nbox)
    if x.device.type != "cuda":
        raise RuntimeError(f"unpack_to_box: unsupported device {x.device}")
    x = x.contiguous()
    box = torch.empty((b, r, nbox), dtype=_complex_of(x.dtype),
                      device=x.device)
    lib = build.library("gamma_pack")
    rc = getattr(lib, "unpack_to_box" + suffix)(
        x.data_ptr(), mask_p.contiguous().data_ptr(),
        slot_re.contiguous().data_ptr(), slot_im.contiguous().data_ptr(),
        im_sign.contiguous().data_ptr(), scale.contiguous().data_ptr(),
        fft_index.contiguous().data_ptr(), box.data_ptr(), b * r, ngk, nbox,
        build.stream_of(x))
    build.count_launch(unpack_to_box, suffix)
    build.check(rc, "unpack_to_box" + suffix)
    return box


unpack_to_box.launches = 0
unpack_to_box.launches_f32 = 0


# K8b's threads a block and rows a thread (csrc/gamma_pack.cu's PACK_ROWS)
PACK_THREADS = 256
PACK_ROWS = 2


def pack_plan(nrows: int, ngk: int, npair: int) -> dict:
    """K8b's grid: one thread a pair in sphere order (the threads past P on
    slot 0 and the padding slots), PACK_THREADS a block along x, and
    PACK_ROWS rows a thread, a block along y."""
    blocks = (-(-(ngk - npair) // PACK_THREADS), -(-nrows // PACK_ROWS))
    return {"rows_per_thread": PACK_ROWS, "blocks": blocks,
            "threads": PACK_THREADS}


def box_to_packed_hx_plain(vbox, x, ekin_p, mask_p, rep_box, par_box,
                           zero_box):
    npair = rep_box.shape[0]
    vr = vbox[..., rep_box.long()]
    vp = vbox[..., par_box.long()]
    vpack = torch.zeros_like(x)
    vpack[..., 0] = vbox[..., zero_box].real
    # a Python float: a float32 block multiplies by its float32 rounding,
    # as the JAX package's weakly typed float(0.5 * sqrt2)
    vpack[..., 1:1 + npair] = HALF_SQRT2 * vr.real + HALF_SQRT2 * vp.real
    vpack[..., 1 + npair:1 + 2 * npair] = (HALF_SQRT2 * vr.imag
                                           - HALF_SQRT2 * vp.imag)
    xm = x * mask_p
    ek = torch.where(mask_p > 0, ekin_p, 0.0)
    return (ek * xm + vpack) * mask_p, xm * mask_p


def box_to_packed_hx(vbox, x, ekin_p, mask_p, rep_box, par_box,
                     zero_box: int):
    """Gather a transformed box [B, R, nbox] back into the packed real
    slots, fused with the kinetic term and the mask: returns (hx, sx)."""
    _check_packed("x", x)
    _, suffix = build.variant(x.dtype)
    if vbox.dtype != _complex_of(x.dtype) or vbox.dim() != 3:
        raise ValueError(f"vbox must be {_complex_of(x.dtype)} [B, rows, "
                         f"nbox] for {x.dtype} x, got {vbox.dtype}")
    b, r, ngk = x.shape
    nbox = vbox.shape[2]
    if tuple(vbox.shape[:2]) != (b, r) or vbox.device != x.device:
        raise ValueError(f"vbox {tuple(vbox.shape)} does not match x "
                         f"{tuple(x.shape)}")
    _check_tables(ngk, x.device, x.dtype, ekin_p=ekin_p, mask_p=mask_p,
                  rep_box=rep_box, par_box=par_box)
    npair = rep_box.shape[0]
    if par_box.shape[0] != npair or 1 + 2 * npair > ngk:
        raise ValueError(f"{npair} pairs do not fit {ngk} packed slots")
    if not 0 <= zero_box < nbox:
        raise ValueError(f"zero_box {zero_box} outside the {nbox}-point box")
    if x.device.type == "cpu":
        return box_to_packed_hx_plain(vbox, x, ekin_p, mask_p, rep_box,
                                      par_box, zero_box)
    if x.device.type != "cuda":
        raise RuntimeError(f"box_to_packed_hx: unsupported device {x.device}")
    vbox, x = vbox.contiguous(), x.contiguous()
    hx = torch.empty_like(x)
    sx = torch.empty_like(x)
    lib = build.library("gamma_pack")
    rc = getattr(lib, "box_to_packed_hx" + suffix)(
        vbox.data_ptr(), x.data_ptr(), ekin_p.contiguous().data_ptr(),
        mask_p.contiguous().data_ptr(), rep_box.contiguous().data_ptr(),
        par_box.contiguous().data_ptr(), int(zero_box), npair, hx.data_ptr(),
        sx.data_ptr(), b * r, ngk, nbox, build.stream_of(x))
    build.count_launch(box_to_packed_hx, suffix)
    build.check(rc, "box_to_packed_hx" + suffix)
    return hx, sx


box_to_packed_hx.launches = 0
box_to_packed_hx.launches_f32 = 0
