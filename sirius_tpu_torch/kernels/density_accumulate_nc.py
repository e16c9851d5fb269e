"""K12b: the four-component spinor density accumulation
(csrc/density_accumulate.cu, density_accumulate_nc).

density_accumulate_nc(acc, fr, occ_w, scale) adds, for fr [nb, 2, N] (the
inverse-FFT box of one k-point's spinor bands, component 0 up, 1 down) and
occ_w [nb],
    acc[0] += scale sum_b w_b (|u|^2 + |d|^2)     rho
    acc[1] += scale sum_b w_b (|u|^2 - |d|^2)     m_z
    acc[2] += 2 scale sum_b w_b Re(u conj d)      m_x
    acc[3] += -2 scale sum_b w_b Im(u conj d)     m_y
into acc [4, N] in place: the reference's (rho, m_z, m_x, m_y) order.
Called once per k-point in k order. Replaces the fusion of
sirius_tpu/parallel/batched_nc.py::density_kset_nc (:141-152). fr is
complex128 or, on the fp32 wave-function path, complex64 (counted apart in
.launches_c64; widened to float64 before the products, occ_w and acc
float64). A CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def density_accumulate_nc_plain(acc, fr, occ_w, scale):
    fr = fr.to(torch.complex128)
    u, d = fr[:, 0], fr[:, 1]
    up = torch.einsum("b,br->r", occ_w, u.real ** 2 + u.imag ** 2)
    dn = torch.einsum("b,br->r", occ_w, d.real ** 2 + d.imag ** 2)
    z2 = torch.einsum("b,br->r", occ_w.to(fr.dtype), u * d.conj())
    acc += scale * torch.stack([up + dn, up - dn, 2.0 * z2.real,
                                -2.0 * z2.imag])
    return acc


def density_accumulate_nc(acc, fr, occ_w, scale: float):
    if fr.dtype not in (torch.complex128, torch.complex64) or fr.dim() != 3 \
            or fr.shape[1] != 2:
        raise ValueError("fr must be complex128 or complex64 [nb, 2, N]")
    _, suffix = build.variant(fr.dtype)
    nb, _, n = fr.shape
    if acc.dtype != torch.float64 or tuple(acc.shape) != (4, n) \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous float64 [4, N] tensor")
    if occ_w.dtype != torch.float64 or tuple(occ_w.shape) != (nb,):
        raise ValueError("occ_w must be float64 [nb]")
    if not (acc.device == fr.device == occ_w.device):
        raise ValueError("acc, fr and occ_w must be on one device")
    if fr.device.type == "cpu":
        return density_accumulate_nc_plain(acc, fr, occ_w, scale)
    if fr.device.type != "cuda":
        raise RuntimeError(f"density_accumulate_nc: unsupported device "
                           f"{fr.device}")
    fr = fr.contiguous()
    occ_w = occ_w.contiguous()
    lib = build.library("density_accumulate")
    rc = getattr(lib, "density_accumulate_nc" + suffix)(
        fr.data_ptr(), occ_w.data_ptr(), acc.data_ptr(), nb, n, float(scale),
        build.stream_of(fr))
    build.count_launch(density_accumulate_nc, suffix)
    build.check(rc, "density_accumulate_nc" + suffix)
    return acc


density_accumulate_nc.launches = 0
density_accumulate_nc.launches_c64 = 0
