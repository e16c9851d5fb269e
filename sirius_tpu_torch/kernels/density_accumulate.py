"""K3: occupation-weighted |psi(r)|^2 accumulation
(csrc/density_accumulate.cu).

density_accumulate(acc, fr, occ_w, scale) adds
scale * sum_b occ_w[s, b] |fr[s, b, r]|^2 into acc [ns, N] in place, for
fr [ns, nb, N] (the inverse-FFT box of one k-point) and occ_w [ns, nb].
Called once per k-point in k order. fr is complex128 or, on the fp32
wave-function path, complex64 (counted apart in .launches_c64); each
element is widened to float64 before it is squared, and occ_w and acc stay
float64. A CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def density_accumulate_plain(acc, fr, occ_w, scale):
    re, im = fr.real.double(), fr.imag.double()
    acc += scale * torch.einsum("sb,sbr->sr", occ_w, re ** 2 + im ** 2)
    return acc


def density_accumulate(acc, fr, occ_w, scale: float):
    if fr.dtype not in (torch.complex128, torch.complex64) or fr.dim() != 3:
        raise ValueError("fr must be complex128 or complex64 [ns, nb, N]")
    _, suffix = build.variant(fr.dtype)
    ns, nb, n = fr.shape
    if acc.dtype != torch.float64 or tuple(acc.shape) != (ns, n) \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous float64 [ns, N] tensor")
    if occ_w.dtype != torch.float64 or tuple(occ_w.shape) != (ns, nb):
        raise ValueError("occ_w must be float64 [ns, nb]")
    if not (acc.device == fr.device == occ_w.device):
        raise ValueError("acc, fr and occ_w must be on one device")
    if fr.device.type == "cpu":
        return density_accumulate_plain(acc, fr, occ_w, scale)
    if fr.device.type != "cuda":
        raise RuntimeError(f"density_accumulate: unsupported device {fr.device}")
    fr = fr.contiguous()
    occ_w = occ_w.contiguous()
    lib = build.library("density_accumulate")
    rc = getattr(lib, "density_accumulate" + suffix)(
        fr.data_ptr(), occ_w.data_ptr(), acc.data_ptr(), ns, nb, n,
        float(scale), build.stream_of(fr))
    build.count_launch(density_accumulate, suffix)
    build.check(rc, "density_accumulate" + suffix)
    return acc


density_accumulate.launches = 0
density_accumulate.launches_c64 = 0
