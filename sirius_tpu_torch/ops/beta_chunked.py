"""Chunked beta projectors, generated on the fly inside the Hamiltonian
application (reference beta_projectors_base.hpp:52,287 and create_beta_gk.cu:
the full [nbeta_total x ngk] table is never materialized; each chunk of
atoms is regenerated from per-type radial tables and structure phases,
applied, and discarded).

Mirrors sirius_tpu/ops/beta_chunked.py. Each chunk step builds the chunk's
projector block (K9, kernels/beta_chunk.py)

    beta[c, xi, G] = pref * (-i)^l * R_lm(^G+k) * RI_rf(|G+k|) * e^{-2pi i (G+k).r_c}

from dense per-radial-function q-tables (linear interpolation), the real
harmonics at the k's G directions and the chunk's atom positions; then
<beta_c|psi> and the D/Q expansions are matrix products. Peak projector
memory is [chunk, nxi_max, ngk] instead of [nbeta_total, ngk].

Host half (BetaChunkTables, build_tables, pack_dmat_chunks): numpy, copied
from the JAX package. Device half (ChunkedParams, make_chunked_hk,
chunked_nonlocal, apply_h_s_chunked): tensors. The preconditioner
diagonals of this path come from the dense table, as in the JAX package
(parallel/batched.py::compute_h_diag / compute_o_diag).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.core.sht import lm_index, num_lm, ylm_real
from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.ops.beta import beta_radial_table
from sirius_tpu_torch.ops.hamiltonian import astype


@dataclasses.dataclass
class BetaChunkTables:
    """Per-k chunked-projector tables (host numpy; upload via params)."""

    # static geometry/metadata, padded per atom to nxi_max
    nxi_max: int
    chunk: int  # atoms per chunk step
    # per-CHUNKED-atom arrays [n_steps, chunk, ...]
    pos: np.ndarray  # [S, C, 3] lattice coords
    xi_rf: np.ndarray  # [S, C, nxi] row into ri_grid
    xi_lm: np.ndarray  # [S, C, nxi] lm index into rlm
    xi_cph: np.ndarray  # [S, C, nxi] complex (-i)^l prefactor (0 for pad)
    dmat: np.ndarray  # [S, C, nxi, nxi] screened D blocks
    qmat: np.ndarray  # [S, C, nxi, nxi] Q blocks (zeros for NC)
    # per-k tables
    rlm: np.ndarray  # [ngk, lmmax]
    q: np.ndarray  # [ngk] |G+k|
    mk: np.ndarray  # [ngk, 3] millers + k
    ri_grid: np.ndarray  # [nrf_tot, NQ] dense radial tables
    dq: float
    pref: float  # 4 pi / sqrt(omega)


def _nxi_max(uc) -> int:
    return max(
        (sum(2 * b.l + 1 for b in uc.atom_types[uc.type_of_atom[ia]].beta)
         for ia in range(uc.num_atoms)),
        default=1,
    )


def build_tables(ctx, ik: int, d_full: np.ndarray | None = None,
                 chunk: int = 16) -> BetaChunkTables:
    """Chunk tables for one k. d_full: the screened [nbeta_tot, nbeta_tot]
    D (defaults to the bare dion); its per-atom diagonal blocks are what
    the chunked apply uses — exactly apply_h_s's contraction restricted to
    the block-diagonal structure D actually has (D couples xi within one
    atom only, non_local_operator.hpp)."""
    uc = ctx.unit_cell
    nat = uc.num_atoms
    qmax = ctx.cfg.parameters.gk_cutoff * 1.05 + 1e-9

    # dense enough that the linear interpolation error (~dq^2 f'') sits
    # below the SCF equality bar: the full chunked band solve must agree
    # with the dense-table path to ~1e-8 Ha
    NQ = max(8192, int(qmax * 768))
    qs = np.linspace(0.0, qmax, NQ)
    ri_rows = []
    rf_off_type = []
    for t in uc.atom_types:
        rf_off_type.append(len(ri_rows))
        tab = beta_radial_table(t, qmax)
        if tab is None:
            continue
        vals = tab(qs)  # [num_beta_rf, NQ]
        for r in np.atleast_2d(vals):
            ri_rows.append(r)
    ri_grid = np.asarray(ri_rows) if ri_rows else np.zeros((1, NQ))

    lmax = max((t.lmax_beta for t in uc.atom_types if t.num_beta), default=0)
    nxi_max = _nxi_max(uc)
    n_steps = (nat + chunk - 1) // chunk
    pos = np.zeros((n_steps, chunk, 3))
    xi_rf = np.zeros((n_steps, chunk, nxi_max), dtype=np.int32)
    xi_lm = np.zeros((n_steps, chunk, nxi_max), dtype=np.int32)
    xi_cph = np.zeros((n_steps, chunk, nxi_max), dtype=np.complex128)
    dmat = np.zeros((n_steps, chunk, nxi_max, nxi_max))
    qmat = np.zeros((n_steps, chunk, nxi_max, nxi_max))
    d_src = d_full if d_full is not None else ctx.beta.dion
    q_src = ctx.beta.qmat
    for ia, off, nbf in ctx.beta.atom_blocks(uc):
        s, c = divmod(ia, chunk)
        t = uc.atom_types[uc.type_of_atom[ia]]
        pos[s, c] = uc.positions[ia]
        idxrf, ls, ms = t.beta_lm_table()
        for xi in range(nbf):
            l, m, ir = int(ls[xi]), int(ms[xi]), int(idxrf[xi])
            xi_rf[s, c, xi] = rf_off_type[uc.type_of_atom[ia]] + ir
            xi_lm[s, c, xi] = lm_index(l, m)
            xi_cph[s, c, xi] = (-1j) ** l
        dmat[s, c, :nbf, :nbf] = np.real(d_src[off : off + nbf, off : off + nbf])
        if q_src is not None:
            qmat[s, c, :nbf, :nbf] = np.real(
                q_src[off : off + nbf, off : off + nbf]
            )

    gk = np.asarray(ctx.gkvec.gkcart[ik])
    q = np.linalg.norm(gk, axis=-1)
    rhat = np.where(
        q[:, None] > 1e-30, gk / np.maximum(q, 1e-30)[:, None],
        np.array([0.0, 0.0, 1.0]),
    )
    rlm = ylm_real(lmax, rhat)[:, : num_lm(lmax)]
    mk = np.asarray(ctx.gkvec.millers[ik]) + np.asarray(ctx.gkvec.kpoints[ik])[None, :]
    return BetaChunkTables(
        nxi_max=nxi_max, chunk=chunk, pos=pos, xi_rf=xi_rf, xi_lm=xi_lm,
        xi_cph=xi_cph, dmat=dmat, qmat=qmat, rlm=rlm, q=q, mk=mk,
        ri_grid=ri_grid, dq=float(qs[1] - qs[0]),
        pref=4.0 * np.pi / np.sqrt(uc.omega),
    )


def pack_dmat_chunks(ctx, d_full: np.ndarray, chunk: int = 16) -> np.ndarray:
    """Per-atom diagonal blocks of a screened [nbeta, nbeta] D matrix packed
    into the fixed [n_steps, chunk, nxi_max, nxi_max] chunk layout (the same
    fill build_tables applies to its dmat)."""
    uc = ctx.unit_cell
    n_steps = (uc.num_atoms + chunk - 1) // chunk
    nxi_max = _nxi_max(uc)
    out = np.zeros((n_steps, chunk, nxi_max, nxi_max))
    for ia, off, nbf in ctx.beta.atom_blocks(uc):
        s, c = divmod(ia, chunk)
        out[s, c, :nbf, :nbf] = np.real(
            d_full[off : off + nbf, off : off + nbf]
        )
    return out


@dataclasses.dataclass
class ChunkedParams:
    """Tensors of the chunked H/S application at one k (the JAX package's
    make_chunked_hk dict, with the (-i)^l prefactors complex). ekin, mask,
    fft_index and veff_r carry a leading batch axis of one, as HkParams
    does; veff_r, dmat and the preconditioner diagonals follow the
    potential and are swapped by the SCF loop. The types below are the fp64
    ones; astype(params, complex64) gives the fp32 set, whose K9 builds
    complex64 projectors from float32 tables (dq and pref stay Python
    floats, which a float32 operand rounds to float32)."""

    ekin: torch.Tensor  # [1, ngk] float64
    mask: torch.Tensor  # [1, ngk] float64
    fft_index: torch.Tensor  # [1, ngk] int32
    veff_r: torch.Tensor  # [1, n1, n2, n3] float64
    dmat: torch.Tensor  # [S, C, nxi, nxi] float64 screened D blocks
    qmat_c: torch.Tensor | None  # [S, C, nxi, nxi] float64; None where Q == 0
    pos: torch.Tensor  # [S, C, 3] float64
    xi_rf: torch.Tensor  # [S, C, nxi] int32
    xi_lm: torch.Tensor  # [S, C, nxi] int32
    cph: torch.Tensor  # [S, C, nxi] complex128
    rlm: torch.Tensor  # [ngk, lmmax] float64
    q: torch.Tensor  # [ngk] float64
    mk: torch.Tensor  # [ngk, 3] float64
    ri_grid: torch.Tensor  # [nrf, NQ] float64
    dq: float
    pref: float
    h_diag: torch.Tensor | None = None  # [1, ngk], set by the SCF loop
    o_diag: torch.Tensor | None = None  # [1, ngk], set by the SCF loop

    @property
    def num_steps(self) -> int:
        return self.pos.shape[0]

    def beta(self, s: int) -> torch.Tensor:
        """The projectors of chunk step s, [C, nxi, ngk] complex (K9), with
        the G mask baked in as the dense table has it."""
        from sirius_tpu_torch.kernels.beta_chunk import beta_chunk

        return beta_chunk(self.pos[s], self.xi_rf[s], self.xi_lm[s],
                          self.cph[s], self.rlm, self.q, self.mk, self.ri_grid,
                          self.dq, self.pref, self.mask[0])


def chunked_params_from_arrays(a: dict, device,
                               dtype=torch.complex128) -> ChunkedParams:
    """ChunkedParams from host arrays under the JAX make_chunked_hk names
    (ekin, mask, fft_index, veff_r, dmat, qmat_c, pos, xi_rf, xi_lm, rlm, q,
    mk, ri_grid, dq, pref) plus complex ``cph``, at the working dtype
    (complex64: the fp32 tables); per-k leaves gain the batch axis of
    one."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    f64, i32 = torch.float64, torch.int32
    nbox = int(np.prod(np.shape(a["veff_r"])))
    fidx = np.asarray(a["fft_index"])
    if fidx.size and (fidx.min() < 0 or fidx.max() >= nbox):
        raise ValueError(f"fft_index outside the {nbox}-point box")
    # K9 trusts the table indices too
    nrf, lmmax = np.shape(a["ri_grid"])[0], np.shape(a["rlm"])[1]
    for name, hi in (("xi_rf", nrf), ("xi_lm", lmmax)):
        idx = np.asarray(a[name])
        if idx.size and (idx.min() < 0 or idx.max() >= hi):
            raise ValueError(f"{name} outside its table of {hi} rows")
    qmat = np.asarray(a["qmat_c"])
    return astype(ChunkedParams(
        ekin=t(a["ekin"], f64).reshape(1, -1),
        mask=t(a["mask"], f64).reshape(1, -1),
        fft_index=t(fidx, i32).reshape(1, -1),
        veff_r=t(a["veff_r"], f64).reshape((1,) + np.shape(a["veff_r"])[-3:]),
        dmat=t(a["dmat"], f64),
        qmat_c=t(qmat, f64) if np.any(qmat != 0) else None,
        pos=t(a["pos"], f64), xi_rf=t(a["xi_rf"], i32),
        xi_lm=t(a["xi_lm"], i32), cph=t(a["cph"], torch.complex128),
        rlm=t(a["rlm"], f64), q=t(a["q"], f64), mk=t(a["mk"], f64),
        ri_grid=t(a["ri_grid"], f64), dq=float(a["dq"]),
        pref=float(a["pref"])), dtype)


def make_chunked_hk(ctx, ik: int, chunk: int = 16, device=None,
                    dtype=torch.complex128) -> ChunkedParams:
    """Constant tables of apply_h_s_chunked at one k; veff_r (zeros) and
    dmat (the bare D) are placeholders the SCF loop swaps per iteration.
    device=None is the GPU and raises without CUDA; dtype complex64 gives
    the fp32 tables (the JAX package's make_chunked_hk(dtype=))."""
    tb = build_tables(ctx, ik, chunk=chunk)
    return chunked_params_from_arrays(dict(
        ekin=ctx.gkvec.kinetic()[ik], mask=ctx.gkvec.mask[ik],
        fft_index=ctx.gkvec.fft_index[ik],
        veff_r=np.zeros(tuple(ctx.fft_coarse.dims)), dmat=tb.dmat,
        qmat_c=tb.qmat, pos=tb.pos, xi_rf=tb.xi_rf, xi_lm=tb.xi_lm,
        cph=tb.xi_cph, rlm=tb.rlm, q=tb.q, mk=tb.mk, ri_grid=tb.ri_grid,
        dq=tb.dq, pref=tb.pref), device, dtype)


def chunked_nonlocal(prm: ChunkedParams, psi: torch.Tensor):
    """(sum_chunks beta^T D <beta|psi>, same with Q): the non-local H and S
    corrections of psi [B, R, ngk], holding one chunk of projectors at a
    time (K9 per chunk step, then matrix products). The chunk's projectors
    carry the G mask, so <beta|psi> ignores padded slots whatever psi holds
    there. The S term is zero where Q is (norm-conserving species)."""
    b, r, ngk = psi.shape
    x = psi.reshape(b * r, ngk)
    hacc = torch.zeros_like(x)
    sacc = torch.zeros_like(x)
    for s in range(prm.num_steps):
        beta = prm.beta(s)  # [C, nxi, ngk]
        c, nxi, _ = beta.shape
        flat = beta.view(c * nxi, ngk)
        bp = torch.matmul(x, flat.conj().T).view(b * r, c, nxi)
        hd = torch.einsum("ncx,cxy->ncy", bp, prm.dmat[s].to(bp.dtype))
        hacc += torch.matmul(hd.reshape(b * r, c * nxi), flat)
        if prm.qmat_c is not None:
            sq = torch.einsum("ncx,cxy->ncy", bp, prm.qmat_c[s].to(bp.dtype))
            sacc += torch.matmul(sq.reshape(b * r, c * nxi), flat)
    return hacc.view(b, r, ngk), sacc.view(b, r, ngk)


def apply_h_s_chunked(prm: ChunkedParams, psi: torch.Tensor):
    """(H psi, S psi) for psi [B, R, ngk] with on-the-fly chunked
    projectors: the local part of ops.hamiltonian.apply_h_s (K1, cuFFT, K1c,
    cuFFT, K1) plus chunked_nonlocal's loop."""
    from sirius_tpu_torch.ops.hamiltonian import HkParams, apply_h_s

    apply_h_s_chunked.calls += 1
    ngk = psi.shape[-1]
    empty = torch.zeros((1, 0, ngk), dtype=psi.dtype, device=psi.device)
    local = HkParams(veff_r=prm.veff_r, ekin=prm.ekin, mask=prm.mask,
                     fft_index=prm.fft_index, beta=empty,
                     dion=empty.new_zeros((1, 0, 0)))
    hpsi, spsi = apply_h_s(local, psi)  # spsi is the masked psi
    hnl, snl = chunked_nonlocal(prm, spsi)
    m = prm.mask[:, None, :]
    if prm.qmat_c is not None:
        spsi = spsi + snl
    return (hpsi + hnl) * m, spsi * m


apply_h_s_chunked.calls = 0

