"""K16: the per-spin density from the coarse-box accumulation, the two
passes around the forward FFT (csrc/density_scatter.cu), and the plain
version.

density_scatter(acc [ns, n1, n2, n3] float64, omega, table [ng]
int32, ng) returns [ns, ng] complex128 rho(G) on the fine set: acc / Omega
(K16a, straight into the complex128 coarse box), the forward FFT (cuFFT,
1/N inside), then every fine slot from the coarse box slot of the same G
or zero (K16b). The table is dft/density.py::grid_tables'
`fine_to_coarse_box`. Replaces sirius_tpu/dft/fused.py::_step_impl
:311-318 and the host loop's density_from_coarse_acc. On a CPU tensor
each pass takes its plain version (the division, the sphere gather and
the zero-filled scatter, as r_to_g and the scatter of dft/density.py
did); on a CUDA tensor each launches its kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.kernels import build


def fine_to_coarse_box(fft_index_coarse, coarse_to_fine,
                       ng: int) -> np.ndarray:
    """[ng] int32: for every fine G the coarse box slot of the same G
    (fft_index_coarse of its coarse index), -1 where it lies outside the
    coarse sphere. Raises unless coarse_to_fine is one-to-one into the
    fine set."""
    idx = np.asarray(fft_index_coarse, dtype=np.int64)
    c2f = np.asarray(coarse_to_fine, dtype=np.int64)
    if c2f.shape != idx.shape or (c2f.size and (c2f.min() < 0
                                                or c2f.max() >= ng)):
        raise ValueError("coarse_to_fine must map every coarse G into the "
                         "fine set")
    if np.unique(c2f).size != c2f.size:
        raise ValueError("coarse_to_fine maps two coarse G to one fine G")
    table = np.full(ng, -1, dtype=np.int32)
    table[c2f] = idx
    return table


def coarse_box_plain(acc, omega: float) -> torch.Tensor:
    return (acc / omega).to(torch.complex128)


def scatter_fine_plain(boxg, table, ng: int) -> torch.Tensor:
    t = table.long()
    fine = torch.nonzero(t >= 0).reshape(-1)
    out = torch.zeros((boxg.shape[0], ng), dtype=torch.complex128,
                      device=boxg.device)
    out[:, fine] = boxg[:, t[fine]]
    return out


def _transform(box) -> torch.Tensor:
    """The forward FFT between the passes (cuFFT on the card), 1/N inside,
    as [ns, nbox]."""
    return torch.fft.fftn(box, dim=(-3, -2, -1),
                          norm="forward").reshape(box.shape[0], -1)


def density_scatter_plain(acc, omega: float, table, ng: int) -> torch.Tensor:
    """The same function in PyTorch ops: acc / Omega, the complex cast, the
    FFT, the gather of the coarse sphere and its scatter into a zeroed
    [ns, ng]."""
    return scatter_fine_plain(_transform(coarse_box_plain(acc, omega)), table,
                              ng)


def _check(acc, table, ng: int):
    if acc.dim() != 4 or acc.dtype != torch.float64:
        raise ValueError("acc must be float64 [ns, n1, n2, n3]")
    if (table.dtype != torch.int32 or tuple(table.shape) != (ng,)
            or table.device != acc.device):
        raise ValueError(f"table must be int32 [{ng}] on the device of acc")


def coarse_box(acc, omega: float) -> torch.Tensor:
    """K16a: the complex128 coarse box acc / Omega (the plain version's
    bits: acc * (1 / Omega), as PyTorch divides a CUDA tensor by a host
    scalar)."""
    if not build.on_cuda(acc, "coarse_box"):
        return coarse_box_plain(acc, omega)
    acc = acc.contiguous()
    box = torch.empty(acc.shape, dtype=torch.complex128, device=acc.device)
    rc = build.library("density_scatter").coarse_box(
        acc.data_ptr(), 1.0 / float(omega), acc.numel(), box.data_ptr(),
        build.stream_of(acc))
    coarse_box.launches += 1
    build.check(rc, "coarse_box")
    return box


coarse_box.launches = 0


def scatter_fine(boxg, table, ng: int) -> torch.Tensor:
    """K16b: [ns, ng] from the transformed coarse boxes boxg [ns, nbox]
    complex128 through the table, every fine slot written once."""
    if boxg.dtype != torch.complex128 or boxg.dim() != 2:
        raise ValueError("boxg must be complex128 [ns, nbox]")
    if (table.dtype != torch.int32 or tuple(table.shape) != (ng,)
            or table.device != boxg.device):
        raise ValueError(f"table must be int32 [{ng}] on the device of boxg")
    if not build.on_cuda(boxg, "scatter_fine"):
        return scatter_fine_plain(boxg, table, ng)
    boxg = boxg.contiguous()
    ns, nbox = boxg.shape
    out = torch.empty((ns, ng), dtype=torch.complex128, device=boxg.device)
    rc = build.library("density_scatter").scatter_fine(
        boxg.data_ptr(), table.contiguous().data_ptr(), ns, nbox, ng,
        out.data_ptr(), build.stream_of(boxg))
    scatter_fine.launches += 1
    build.check(rc, "scatter_fine")
    return out


scatter_fine.launches = 0


def density_scatter(acc, omega: float, table, ng: int) -> torch.Tensor:
    """rho(G) [ns, ng] complex128 of the coarse-box accumulation acc: K16a,
    the forward FFT, K16b (their plain versions on a CPU tensor)."""
    _check(acc, table, ng)
    return scatter_fine(_transform(coarse_box(acc, omega)), table, ng)
