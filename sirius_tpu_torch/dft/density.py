"""Charge density: initial guess and assembly from the coarse-box
accumulation.

Mirrors the parts of sirius_tpu/dft/density.py on this slice's path
(reference src/density/density.cpp: initial_density :137, generate :1105).
The occupation-weighted |psi(r)|^2 sum itself is parallel/batched.py::
density_kset (K1 scatter + cuFFT + K3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
from sirius_tpu_torch.device import resolve_device


@dataclasses.dataclass
class GridTables:
    """The fine and coarse G-set tables the density and potential steps
    read, uploaded to the device once per run."""

    dims: tuple[int, int, int]  # fine box
    dims_coarse: tuple[int, int, int]
    omega: float
    fft_index: torch.Tensor  # [ng] int32, fine G -> fine box
    glen2: torch.Tensor  # [ng] float64
    fft_index_coarse: torch.Tensor  # [ngc] int32, coarse G -> coarse box
    coarse_to_fine: torch.Tensor  # [ngc] int64
    vloc_g: torch.Tensor  # [ng] complex128
    rho_core_g: torch.Tensor | None  # [ng] complex128, None without NLCC
    vloc_r: torch.Tensor  # fine box, float64
    rho_core_r: torch.Tensor  # fine box, float64 (zeros without NLCC)


def grid_tables(ctx: SimulationContext, device) -> GridTables:
    device = resolve_device(device)
    # the kernels trust the index tables: check them against the boxes once
    for idx, fft in ((ctx.gvec.fft_index, ctx.gvec.fft),
                     (ctx.gvec_coarse.fft_index, ctx.fft_coarse)):
        if idx.min() < 0 or idx.max() >= fft.num_points:
            raise ValueError(f"fft_index outside the {fft.dims} box")
    dims = tuple(ctx.gvec.fft.dims)
    fidx = torch.as_tensor(ctx.gvec.fft_index, device=device)
    vloc_g = torch.as_tensor(ctx.vloc_g, dtype=torch.complex128, device=device)
    has_core = bool(np.any(ctx.rho_core_g))
    core_g = (torch.as_tensor(ctx.rho_core_g, dtype=torch.complex128,
                              device=device) if has_core else None)
    return GridTables(
        dims=dims,
        dims_coarse=tuple(ctx.fft_coarse.dims),
        omega=float(ctx.unit_cell.omega),
        fft_index=fidx,
        glen2=torch.as_tensor(ctx.gvec.glen2, device=device),
        fft_index_coarse=torch.as_tensor(ctx.gvec_coarse.fft_index,
                                         device=device),
        coarse_to_fine=torch.as_tensor(ctx.coarse_to_fine, device=device),
        vloc_g=vloc_g,
        rho_core_g=core_g,
        vloc_r=g_to_r(vloc_g, fidx, dims).real,
        rho_core_r=(g_to_r(core_g, fidx, dims).real if has_core
                    else torch.zeros(dims, dtype=torch.float64, device=device)),
    )


def initial_density_g(ctx: SimulationContext) -> np.ndarray:
    """Superposition of free-atom densities, normalized to the electron
    count (reference density.cpp:137 initial_density_pseudo)."""
    rho_g = ctx.rho_atomic_g.copy()
    nel = ctx.unit_cell.num_valence_electrons
    n0 = rho_g[0].real * ctx.unit_cell.omega
    if abs(n0) < 1e-12:
        raise ValueError("free-atom density missing in species files")
    rho_g *= nel / n0
    return rho_g


def density_from_coarse_acc(ctx: SimulationContext, acc: torch.Tensor,
                            tables: GridTables) -> torch.Tensor:
    """Finalize the per-spin density from the occupation-weighted |psi(r)|^2
    accumulation on the coarse box: divide by Omega, transform to coarse G,
    map to the fine G set. acc: [nspin, n1, n2, n3] real; returns
    [nspin, ng] complex128 on acc's device."""
    ns = acc.shape[0]
    out = torch.zeros((ns, ctx.gvec.num_gvec), dtype=torch.complex128,
                      device=acc.device)
    rho_g_coarse = r_to_g(acc / tables.omega, tables.fft_index_coarse,
                          tables.dims_coarse)
    out[:, tables.coarse_to_fine] = rho_g_coarse
    return out


def rho_real_space(tables: GridTables, rho_g: torch.Tensor) -> torch.Tensor:
    """rho(r) on the fine box."""
    return g_to_r(rho_g, tables.fft_index, tables.dims).real
