"""Charge and magnetization density: initial guess and assembly from the
coarse-box accumulation.

Mirrors the parts of sirius_tpu/dft/density.py on this slice's path
(reference src/density/density.cpp: initial_density :137, generate :1105),
including the collinear initial magnetization and the per-atom moments
(density.py:93-152, :295-318; host numpy, ported by copy).
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
from sirius_tpu_torch.core.fftgrid import g_to_r
from sirius_tpu_torch.core.radial import sbessel_integral
from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.kernels.coarse_potential import coarse_box_to_fine
from sirius_tpu_torch.kernels.density_scatter import (
    density_scatter,
    fine_to_coarse_box,
)
from sirius_tpu_torch.kernels.symmetrize_pw import (
    Cosets,
    build_cosets,
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
    fft_index: torch.Tensor  # [ng] int32, fine G -> fine box, one-to-one
    box_to_g: torch.Tensor  # [nbox] int32, its inverse, -1 off the G set
    glen2: torch.Tensor  # [ng] float64
    gcart: torch.Tensor  # [ng, 3] float64 Cartesian G (GGA gradients)
    # [ng] int32, fine G -> coarse box slot of the same G, -1 outside the
    # coarse sphere (K16's table)
    fine_to_coarse_box: torch.Tensor
    # [n_coarse_box] int32, coarse box slot -> fine G of the same G, -1
    # outside the coarse sphere (K17d's table, the inverse of K16's)
    coarse_box_to_fine: torch.Tensor
    vloc_g: torch.Tensor  # [ng] complex128
    rho_core_g: torch.Tensor | None  # [ng] complex128, None without NLCC
    vloc_r: torch.Tensor  # fine box, float64
    # fine box, contiguous float64 (zeros without NLCC)
    rho_core_r: torch.Tensor
    sym: SymPwTables | None = None  # K6 tables where the SCF symmetrizes


def grid_tables(ctx: SimulationContext, device) -> GridTables:
    device = resolve_device(device)
    # the kernels trust the index tables: check them against the boxes once
    for idx, fft in ((ctx.gvec.fft_index, ctx.gvec.fft),
                     (ctx.gvec_coarse.fft_index, ctx.fft_coarse)):
        if idx.min() < 0 or idx.max() >= fft.num_points:
            raise ValueError(f"fft_index outside the {fft.dims} box")
    # the fine G set has no padded lanes: fft_index is one-to-one, and the
    # gradient boxes (K10a) walk the box through its inverse
    if len(np.unique(ctx.gvec.fft_index)) != ctx.gvec.num_gvec:
        raise ValueError("fine fft_index is not one-to-one on the G set")
    box_to_g = np.full(ctx.gvec.fft.num_points, -1, dtype=np.int32)
    box_to_g[ctx.gvec.fft_index] = np.arange(ctx.gvec.num_gvec, dtype=np.int32)
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
        box_to_g=torch.as_tensor(box_to_g, device=device),
        glen2=torch.as_tensor(ctx.gvec.glen2, device=device),
        gcart=torch.as_tensor(np.asarray(ctx.gvec.gcart, dtype=np.float64),
                              device=device),
        fine_to_coarse_box=torch.as_tensor(fine_to_coarse_box(
            ctx.gvec_coarse.fft_index, ctx.coarse_to_fine,
            ctx.gvec.num_gvec), device=device),
        coarse_box_to_fine=torch.as_tensor(coarse_box_to_fine(
            ctx.gvec_coarse.fft_index, ctx.coarse_to_fine,
            ctx.fft_coarse.num_points, ctx.gvec.num_gvec), device=device),
        vloc_g=vloc_g,
        rho_core_g=core_g,
        vloc_r=g_to_r(vloc_g, fidx, dims).real.contiguous(),
        rho_core_r=(g_to_r(core_g, fidx, dims).real.contiguous() if has_core
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


def atomic_sphere_radii(uc, rmax: float = 2.0) -> np.ndarray:
    """Per-atom non-overlapping sphere radii: half the nearest-neighbor
    distance over periodic images (including an atom's own images, so
    single-atom cells are covered), capped at rmax."""
    pos = uc.positions_cart()
    ts = np.array(
        np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij")
    ).reshape(3, -1).T @ uc.lattice
    d = np.linalg.norm(
        pos[:, None, None, :] - pos[None, :, None, :] - ts[None, None, :, :],
        axis=-1,
    )
    d[d < 1e-8] = np.inf
    return np.minimum(0.5 * d.min(axis=(1, 2)), rmax)


def initial_magnetization_vec_g(ctx: SimulationContext) -> np.ndarray:
    """[3, ng] initial (mx, my, mz) from per-atom starting moment vectors.
    Two seeds, selected by settings.smooth_initial_mag (reference
    density.cpp initial_density_pseudo): smooth, a per-atom Gaussian
    exp(-G^2/(4 alpha)), alpha = 4; default, the compact normalized bump
    w(R, x) = (1 - (x/R)^2) e^{x/R} / (3.18866 R^3) inside an atomic
    sphere."""
    uc = ctx.unit_cell
    gv = ctx.gvec
    out = np.zeros((3, gv.num_gvec), dtype=np.complex128)
    if not np.any(np.abs(uc.moments) > 1e-12):
        return out
    smooth = bool(ctx.cfg.settings.smooth_initial_mag)
    rad = atomic_sphere_radii(uc)
    qshell = np.sqrt(gv.shell_g2)
    for ia in range(uc.num_atoms):
        mvec = uc.moments[ia]
        if np.all(np.abs(mvec) < 1e-12):
            continue
        if smooth:
            alpha = 4.0
            ff = np.exp(-gv.shell_g2 / (4.0 * alpha))[gv.shell_idx]
        else:
            r = np.linspace(1e-8, rad[ia], 400)
            w = (1 - (r / rad[ia]) ** 2) * np.exp(r / rad[ia]) / (
                3.1886583903476735 * rad[ia] ** 3
            )
            ff = sbessel_integral(r, 4.0 * np.pi * w, 0, qshell, m=2)[gv.shell_idx]
        phase = np.exp(-2j * np.pi * (gv.millers @ uc.positions[ia]))
        for i in range(3):
            if abs(mvec[i]) > 1e-12:
                out[i] += (mvec[i] / uc.omega) * ff * phase
    return out


def initial_magnetization_g(ctx: SimulationContext) -> np.ndarray:
    """Initial z-magnetization (collinear): z-component of the vector seed."""
    return initial_magnetization_vec_g(ctx)[2]


def atomic_moments(ctx: SimulationContext, mag_g: np.ndarray) -> np.ndarray:
    """Integral of m_z inside each atom's non-overlapping sphere (reference
    Density::get_magnetisation MT moments):
    int_{|r-ra|<R} e^{iG.r} dr = e^{iG.ra} (4 pi / G^3)(sin GR - GR cos GR).
    Spheres capped at control.rmt_max."""
    gv = ctx.gvec
    uc = ctx.unit_cell
    glen = np.sqrt(gv.glen2)
    radii = atomic_sphere_radii(uc, rmax=ctx.cfg.control.rmt_max)
    out = np.empty(uc.num_atoms)
    for ia in range(uc.num_atoms):
        radius = float(radii[ia])
        gr = glen * radius
        w = np.empty_like(gr)
        small = gr < 1e-8
        w[~small] = 4.0 * np.pi / np.maximum(glen[~small], 1e-30) ** 3 * (
            np.sin(gr[~small]) - gr[~small] * np.cos(gr[~small])
        )
        w[small] = 4.0 * np.pi * radius**3 / 3.0
        phase = np.exp(2j * np.pi * (gv.millers @ uc.positions[ia]))
        out[ia] = float(np.real(mag_g @ (w * phase)))
    return out


def atomic_moments_vec(ctx: SimulationContext, mvec_g: np.ndarray) -> np.ndarray:
    """Per-atom (mx, my, mz) sphere integrals [natoms, 3], the vector form
    of atomic_moments for non-collinear runs. mvec_g: [3, ng]."""
    return np.stack(
        [atomic_moments(ctx, mvec_g[i]) for i in range(3)], axis=1
    )


def density_from_coarse_acc(ctx: SimulationContext, acc: torch.Tensor,
                            tables: GridTables) -> torch.Tensor:
    """Finalize the per-spin density from the occupation-weighted |psi(r)|^2
    accumulation on the coarse box: divide by Omega, transform to coarse G,
    map to the fine G set (K16: kernels/density_scatter.py). acc:
    [nspin, n1, n2, n3] real; returns [nspin, ng] complex128 on acc's
    device."""
    return density_scatter(acc, tables.omega, tables.fine_to_coarse_box,
                           ctx.gvec.num_gvec)


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
    per-op G tables, only the ops and a fine-box -> G lookup; the plain
    versions sum every op, the kernels the coset representatives over the
    live G (cosets)."""

    millers: torch.Tensor  # [ng, 3] int32, fine G set
    lut: torch.Tensor  # [N_fine] int32, box slot -> G index, -1 off the set
    rot: torch.Tensor  # [nops, 3, 3] int32, w_k^{-1}: target -> source Miller
    trans: torch.Tensor  # [nops, 3] float64 fractional translations
    sign: torch.Tensor  # [nops] float64 spin signs (axial fields)
    dims: tuple[int, int, int]  # fine box
    # [nops, 3, 3] float64 det(R) R: the Cartesian rotation of an axial
    # vector (K6v, non-collinear magnetization and B)
    srot: torch.Tensor
    cosets: Cosets  # one op of each rotation, the live G (kernels)

    @property
    def num_ops(self) -> int:
        return self.rot.shape[0]


def _axial_rotations(ops) -> np.ndarray:
    """[nops, 3, 3] det(R) R of each op's Cartesian rotation R: how an axial
    vector (a magnetization) rotates (potential_nc.py:62)."""
    return np.stack([np.linalg.det(op.rot_cart) * op.rot_cart
                     for op in ops]).astype(np.float64)


def build_sym_pw_tables(ctx: SimulationContext, device=None) -> SymPwTables:
    """K6's tables from the context's space group. Checks once that every
    op maps the G set onto itself (the sphere is rotation invariant): each
    rotated Miller index must land, after wrapping into the fine box, on a
    G of the set with exactly that index; and that the ops factor over
    their pure translations (kernels/symmetrize_pw.py::build_cosets, which
    raises ValueError naming the op that does not). The kernels trust
    this."""
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
    millers = np.asarray(gv.millers, dtype=np.int32)
    trans = np.stack([op.t for op in ops]).astype(np.float64)
    sign = np.array([op.spin_sign for op in ops], dtype=np.float64)
    srot = _axial_rotations(ops)
    tb = SymPwTables(
        millers=torch.as_tensor(millers, device=device),
        lut=torch.as_tensor(lut, device=device),
        rot=torch.as_tensor(rot, device=device),
        trans=torch.as_tensor(trans, device=device),
        sign=torch.as_tensor(sign, device=device),
        dims=tuple(int(x) for x in gv.fft.dims),
        srot=torch.as_tensor(srot, device=device),
        cosets=build_cosets(millers, rot, trans, sign, srot, device),
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
                                tb.dims, tb.sign if axial_z else None,
                                tb.cosets)


def symmetrize_tau(tb: SymPwTables, tau_g: torch.Tensor) -> torch.Tensor:
    """The kinetic-energy density per spin [ns, ng] symmetrized as a scalar
    field, each channel under every op (JAX scf.py:1961-1964). Under a
    spin-flip op of a magnetic group the channels should swap instead
    (tau_up(r) -> tau_dn(Rr)); the per-channel scalar average mixes them,
    so a staggered spin difference of tau is averaged to zero. The JAX
    package does the same; both are to change together."""
    return torch.stack([symmetrize_pw(tb, t) for t in tau_g])


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
        "srot": torch.as_tensor(_axial_rotations(ops) if ops else np.eye(3)[None],
                                device=device),
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


def dm_component_blocks(dm3: torch.Tensor) -> torch.Tensor:
    """The blocks of the four fields (rho, m_x, m_y, m_z) from the (uu, dd,
    ud) spin components (JAX scf_nc.py::_dm_component_blocks; reference
    density_matrix_aux, density.cpp:1784-1811), [4, nbeta, nbeta]. Each is
    Hermitian, so the packed Re(dm) contraction of rho_aug (K4) is exact."""
    uu, dd, ud = dm3
    udh = ud.mH
    return torch.stack([uu + dd, ud + udh, 1j * (ud - udh), uu - dd])


def symmetrize_density_matrix_nc_device(dm3: torch.Tensor, tb: dict) -> torch.Tensor:
    """Non-collinear density-matrix symmetrization (JAX density.py:253-285)
    as batched matrix products over the ops. dm3 [3, nbeta, nbeta] complex128
    spin components (uu, dd, ud). Per atom block the scalar d0 = uu + dd
    rotates with the beta rotations alone, the axial vector (dx, dy, dz) =
    (ud + ud^H, i (ud - ud^H), uu - dd) with them and with det(R) R; the
    result is reassembled into (uu, dd, ud) on the diagonal atom blocks."""
    comp = dm_component_blocks(dm3)
    s = tb["s_ops"]
    nops = s.shape[0]
    # rotated components per op: [nops, 4, nbeta, nbeta]
    rc = torch.matmul(torch.matmul(s[:, None], comp[None]), s.mT[:, None])
    srot = tb["srot"].to(rc.dtype)
    dv = torch.einsum("oij,ojab->oiab", srot, rc[:, 1:])
    d0 = rc[:, 0].sum(dim=0)
    dx, dy, dz = dv.sum(dim=0)
    out = torch.stack([0.5 * (d0 + dz), 0.5 * (d0 - dz), 0.5 * (dx - 1j * dy)])
    return out * tb["blockmask"][None] / nops
