"""Charge density: initial guess and assembly from the coarse-box
accumulation.

Mirrors the parts of sirius_tpu/dft/density.py on this slice's path
(reference src/density/density.cpp: initial_density :137, generate :1105).
The occupation-weighted |psi(r)|^2 sum itself is parallel/batched.py::
density_kset (K1 scatter + cuFFT + K3). The space-group symmetrization of
PW coefficients is K6; that of the beta density matrix is batched matrix
products (density.py:155-215, :361-404).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.kernels.symmetrize_pw import (
    source_index,
    symmetrize_pw as symmetrize_pw_kernel,
)
from sirius_tpu_torch.ops.hubbard import rlm_rotation_matrix


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
    sym: SymPwTables | None = None  # K6 tables where the SCF symmetrizes


def grid_tables(ctx: SimulationContext, device) -> GridTables:
    device = resolve_device(device)
    # the kernels trust the index tables: check them against the boxes once
    for idx, fft in ((ctx.gvec.fft_index, ctx.gvec.fft),
                     (ctx.gvec_coarse.fft_index, ctx.fft_coarse)):
        if idx.min() < 0 or idx.max() >= fft.num_points:
            raise ValueError(f"fft_index outside the {fft.dims} box")
    dims = tuple(ctx.gvec.fft.dims)
    # the JAX package's do_symmetrize
    symmetrizes = bool(ctx.cfg.parameters.use_symmetry
                       and ctx.symmetry is not None
                       and ctx.symmetry.num_ops > 1)
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
        sym=build_sym_pw_tables(ctx, device) if symmetrizes else None,
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


# ---------------------------------------------------------------------------
# Symmetrization over the space group (the reduced k-wedge sum only yields
# the full-BZ density after averaging over the operations).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SymPwTables:
    """The space group as K6 (kernels/symmetrize_pw.py) reads it: no
    per-op G tables, only the ops and a fine-box -> G lookup."""

    millers: torch.Tensor  # [ng, 3] int32, fine G set
    lut: torch.Tensor  # [N_fine] int32, box slot -> G index, -1 off the set
    rot: torch.Tensor  # [nops, 3, 3] int32, w_k^{-1}: target -> source Miller
    trans: torch.Tensor  # [nops, 3] float64 fractional translations
    sign: torch.Tensor  # [nops] float64 spin signs (axial fields)
    dims: tuple[int, int, int]  # fine box

    @property
    def num_ops(self) -> int:
        return self.rot.shape[0]


def build_sym_pw_tables(ctx: SimulationContext, device=None) -> SymPwTables:
    """K6's tables from the context's space group. Checks once that every
    op maps the G set onto itself (the sphere is rotation invariant): each
    rotated Miller index must land, after wrapping into the fine box, on a
    G of the set with exactly that index. The kernel trusts this."""
    device = resolve_device(device)
    gv = ctx.gvec
    ops = ctx.symmetry.ops
    rot = np.empty((len(ops), 3, 3), dtype=np.int32)
    for i, op in enumerate(ops):
        winv = np.rint(np.linalg.inv(op.w_k)).astype(np.int64)
        if not np.array_equal(op.w_k @ winv, np.eye(3, dtype=np.int64)):
            raise ValueError(f"symmetry op {i}: w_k is not unimodular")
        rot[i] = winv
    lut = np.full(gv.fft.num_points, -1, dtype=np.int32)
    lut[gv.fft_index] = np.arange(gv.num_gvec, dtype=np.int32)
    tb = SymPwTables(
        millers=torch.as_tensor(np.asarray(gv.millers, dtype=np.int32),
                                device=device),
        lut=torch.as_tensor(lut, device=device),
        rot=torch.as_tensor(rot, device=device),
        trans=torch.as_tensor(np.stack([op.t for op in ops]).astype(np.float64),
                              device=device),
        sign=torch.as_tensor(np.array([op.spin_sign for op in ops],
                                      dtype=np.float64), device=device),
        dims=tuple(int(x) for x in gv.fft.dims),
    )
    m = tb.millers.long()
    ok = torch.ones((), dtype=torch.bool, device=device)
    for i in range(len(ops)):
        g, src = source_index(m, tb.rot[i], tb.lut, tb.dims)
        ok &= (g >= 0).all() & (m[g.clamp(min=0)] == src).all()
    if not bool(ok):
        raise ValueError("a symmetry op maps a G vector outside the G set")
    return tb


def symmetrize_pw(tb: SymPwTables, f_g: torch.Tensor,
                  axial_z: bool = False) -> torch.Tensor:
    """Symmetrize PW coefficients over the space group (K6):
    f'(g') = (1/N) sum_op f(w_k^{-1} g') e^{-2 pi i g' . t_op}, with the
    op's spin sign for the z-component of an axial field (axial_z)."""
    return symmetrize_pw_kernel(f_g, tb.millers, tb.lut, tb.rot, tb.trans,
                                tb.dims, tb.sign if axial_z else None)


def _beta_rotation_blocks(ctx: SimulationContext, op):
    """Per-atom-type block-diagonal Rlm rotation matrices for one symmetry
    op."""
    uc = ctx.unit_cell
    dcache: dict = {}
    rot_by_type: dict = {}
    for ia, off, nbf in ctx.beta.atom_blocks(uc):
        it = uc.type_of_atom[ia]
        if it in rot_by_type:
            continue
        t = uc.atom_types[it]
        rmats = []
        for b in t.beta:
            if b.l not in dcache:
                dcache[b.l] = rlm_rotation_matrix(op.rot_cart, b.l)
            rmats.append(dcache[b.l])
        full = np.zeros((nbf, nbf))
        pos = 0
        for m in rmats:
            k = m.shape[0]
            full[pos : pos + k, pos : pos + k] = m
            pos += k
        rot_by_type[it] = full
    return rot_by_type


def build_dm_sym_tables(ctx: SimulationContext, device=None) -> dict:
    """Per-op dense beta-rotation matrices for the collinear density-matrix
    symmetrization: s_ops [nops, nbeta, nbeta] with
    S[joff + i, off + j] = r[i, j] (joff the permuted atom's block), so
    dm' = (1/N) sum_op S dm S^T reproduces the per-block r @ dm_block @ r.T
    scattered to the permuted block. flipneg marks ops with spin_sign < 0
    (collinear channel swap); blockmask zeroes the inter-atom blocks."""
    device = resolve_device(device)
    sym = ctx.symmetry
    uc = ctx.unit_cell
    nbeta = ctx.beta.num_beta_total
    blocks = list(ctx.beta.atom_blocks(uc))
    off_by_atom = {ia: off for ia, off, _ in blocks}
    ops = sym.ops if sym is not None and sym.num_ops > 1 else []
    s_ops = np.zeros((max(len(ops), 1), nbeta, nbeta))
    flipneg = np.zeros(max(len(ops), 1), dtype=bool)
    if not ops:
        s_ops[0] = np.eye(nbeta)
    for io, op in enumerate(ops):
        rot_by_type = _beta_rotation_blocks(ctx, op)
        flipneg[io] = op.spin_sign < 0
        for ia, off, nbf in blocks:
            r = rot_by_type[uc.type_of_atom[ia]]
            joff = off_by_atom[int(op.perm[ia])]
            s_ops[io, joff : joff + nbf, off : off + nbf] = r
    blockmask = np.zeros((nbeta, nbeta))
    for _, off, nbf in blocks:
        blockmask[off : off + nbf, off : off + nbf] = 1.0
    return {
        "s_ops": torch.as_tensor(s_ops, dtype=torch.complex128, device=device),
        "flipneg": torch.as_tensor(flipneg, device=device),
        "blockmask": torch.as_tensor(blockmask, device=device),
    }


def symmetrize_density_matrix_device(dm: torch.Tensor, tb: dict) -> torch.Tensor:
    """dm' = (1/N) sum_op S_op dm S_op^T on the atom blocks, dm complex128
    [ns, nbeta, nbeta]; for ns == 2 the spin channels swap under flipneg
    ops. Batched matrix products over the ops (a plain GEMM the JAX package
    leaves to XLA)."""
    ns = dm.shape[0]
    s = tb["s_ops"]
    nops = s.shape[0]
    if ns == 2:
        dms = torch.where(tb["flipneg"][:, None, None, None],
                          dm.flip(0)[None], dm[None])
    else:
        dms = dm[None].expand((nops,) + dm.shape)
    out = torch.matmul(torch.matmul(s[:, None], dms), s.mT[:, None]).sum(dim=0)
    return out * tb["blockmask"][None] / nops
