"""Spin-orbit coupling for relativistic (j-resolved) pseudopotentials.

A copy of sirius_tpu/ops/so.py (host numpy; the spinor path of
dft/scf_nc.py calls it once an iteration on [4, nbeta, nbeta] blocks).
Fully-relativistic species carry beta projectors labelled (l, j) with
j = l +- 1/2; the non-local operator acts in the |l j mj> spherical-spinor
basis. Everything reduces to the f-coefficients (Eq. 9 of PhysRevB 71,
115106; reference atom_type.cpp generate_f_coefficients)

  f^{s s'}_{xi1 xi2} = sum_{mj} U^s_{l j mj m1} CG(l, j, mj, s)
                       conj(U^{s'}_{l j mj m2}) CG(l, j, mj, s')

an angular-spinor overlap depending only on (l, j, m1, m2, s, s') — it
vanishes unless (l1, j1) == (l2, j2). The D operator (Eq. 19, reference
non_local_operator.cpp:110-200), the Q operator (Eq. 18, :285-340) and the
<beta|psi> rotation in the density matrix (density.cpp:938-1000) are all
congruences with this tensor restricted to the SAME radial function
(compare_index_beta_functions), while the ionic dion term couples different
radial functions of equal (l, j). Index order follows the reference
verbatim; spin-block storage order here is (uu, dd, ud, du) — the
reference's s_idx = {{0,3},{2,1}} and the local-operator 0/1/2/3 blocks.

The real<->complex harmonic overlaps are built numerically from this
package's own core/sht.py harmonics (_r2y_blocks, a copy of the JAX
package's dft/mt_gradient.py function), so phase conventions are
internally consistent with ops/beta.py's projector tables.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from sirius_tpu_torch.core.sht import (
    _sphere_quadrature,
    lm_index,
    ylm_complex,
    ylm_real,
)
from sirius_tpu_torch.ops.spinor import spin_blocks_from_components

# pauli_matrix[alpha][s1][s2], alpha = (identity, z, x, y) — reference
# core/constants.hpp:48
PAULI = np.array([
    [[1, 0], [0, 1]],
    [[1, 0], [0, -1]],
    [[0, 1], [1, 0]],
    [[0, -1j], [1j, 0]],
], dtype=np.complex128)


@lru_cache(maxsize=8)
def _r2y_blocks(lmax: int):
    """Per-l matrices C with R_lm(x) = sum_m' Y_lm'(x) C[m', m]; i.e. the
    complex coefficients of a real expansion are fY = C @ fR per l block."""
    pts, w = _sphere_quadrature(2 * lmax + 2)
    Y = ylm_complex(lmax, pts)  # [npts, lmmax]
    R = ylm_real(lmax, pts)
    out = []
    for l in range(lmax + 1):
        idx = [lm_index(l, m) for m in range(-l, l + 1)]
        Yl = Y[:, idx]
        Rl = R[:, idx]
        # C = <Y|R> with the quadrature inner product (Y orthonormal)
        C = np.einsum("pi,p,pj->ij", np.conj(Yl), w, Rl)
        out.append((idx, C))
    return out


def _l_matrices_real(l: int):
    """Angular-momentum operators (Lx, Ly, Lz) in THIS package's real-
    harmonic basis: built exactly in the complex basis (Lz|Y_m> = m|Y_m>,
    L+- with sqrt(l(l+1) - m(m+-1))) and transformed with the numerically-
    derived real<->complex block C (R_m2 = sum_m1 Y_m1 C[m1, m2]) — no
    rotation-matrix sign conventions involved."""
    n = 2 * l + 1
    m = np.arange(-l, l + 1)
    lz = np.diag(m.astype(float))
    lp = np.zeros((n, n))
    for mm in range(-l, l):
        # L+|l m> = sqrt(l(l+1) - m(m+1)) |l m+1>
        lp[mm + 1 + l, mm + l] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    lm = lp.T
    lx = 0.5 * (lp + lm)
    ly = -0.5j * (lp - lm)
    C = _r2y_blocks(l)[l][1]
    return [C.conj().T @ op @ C for op in (lx, ly, lz)], C


def j_projector(l: int, j: float) -> np.ndarray:
    """[(2l+1), (2l+1), 2, 2] projector onto the |l j mj> subspace in the
    real-harmonic x spin basis: the spectral projector of J^2 = (L + S)^2
    at eigenvalue j(j+1). Convention-proof by construction — it only uses
    Lz|Y_m> = m|Y_m> and the package's own real<->complex transform."""
    L, _ = _l_matrices_real(l)
    n = 2 * l + 1
    S = [
        0.5 * np.array([[0, 1], [1, 0]], dtype=complex),
        0.5 * np.array([[0, -1j], [1j, 0]], dtype=complex),
        0.5 * np.array([[1, 0], [0, -1]], dtype=complex),
    ]
    # combined index (s, m) with spin-major kron (s*n + m)
    J = [np.kron(np.eye(2), L[i]) + np.kron(S[i], np.eye(n)) for i in range(3)]
    j2 = sum(Ji @ Ji for Ji in J)
    ev, v = np.linalg.eigh(j2)
    sel = np.abs(ev - j * (j + 1)) < 1e-8
    assert sel.sum() == int(round(2 * j + 1)), (l, j, ev)
    p = v[:, sel] @ v[:, sel].conj().T  # [(2n), (2n)] spin-major
    # reshape to [m1, m2, s1, s2]
    p4 = p.reshape(2, n, 2, n)
    return np.transpose(p4, (1, 3, 0, 2))


def f_coefficients(t) -> np.ndarray:
    """[nbf, nbf, 2, 2] complex for one atom type with j-resolved betas:
    f^{s s'}_{xi1 xi2} = <R_{m1} s| P_{l j} |R_{m2} s'> on same-(l, j)
    pairs — the angular-spinor overlap of Eq. 9 PhysRevB 71, 115106,
    constructed as the J^2 spectral projector in this package's own basis
    (the reference builds the same object from U and Clebsch-Gordan
    tables in ITS real-harmonic convention, atom_type.cpp
    generate_f_coefficients)."""
    idx = []  # (idxrf, l, j, m) in ops/beta.py xi order
    for ib, b in enumerate(t.beta):
        for m in range(-b.l, b.l + 1):
            idx.append((ib, b.l, b.j, m))
    nbf = len(idx)
    f = np.zeros((nbf, nbf, 2, 2), dtype=np.complex128)
    pcache = {}
    for x2, (rf2, l2, j2, m2) in enumerate(idx):
        for x1, (rf1, l1, j1, m1) in enumerate(idx):
            if l1 != l2 or abs(j1 - j2) > 1e-8:
                continue
            key = (l1, j1)
            if key not in pcache:
                pcache[key] = j_projector(l1, j1)
            p = pcache[key]
            f[x1, x2] = p[m1 + l1, m2 + l2]
    return f


@dataclasses.dataclass
class SpinOrbitData:
    """Per-type f tensors + masks, expanded over the global beta layout."""

    f_by_type: list  # [nbf, nbf, 2, 2] complex or None per atom type
    frf_by_type: list  # f masked to same radial function (congruence form)
    dion_xi: list  # [nbf, nbf] dion expanded over xi on same-(l, j) pairs
    dion_collinear: list  # [nbf, nbf] the collinear xi-expansion of dion
    # (the piece inside the screened scalar D that must be removed before
    # the Eq. 19 congruence)
    qxi_by_type: list  # [nbf, nbf] q_mtrx in the xi basis (or None)
    blocks: list  # (ia, offset, nbf) global layout
    type_of_atom: np.ndarray

    @staticmethod
    def build(ctx) -> "SpinOrbitData | None":
        uc = ctx.unit_cell
        if not any(t.spin_orbit for t in uc.atom_types):
            return None
        ntypes = len(uc.atom_types)
        f_by_type = [None] * ntypes
        frf_by_type = [None] * ntypes
        dion_xi = [None] * ntypes
        dion_col = [None] * ntypes
        qxi = [None] * ntypes
        blocks = list(ctx.beta.atom_blocks(uc))
        first_block_of_type = {}
        for ia, off, nbf in blocks:
            first_block_of_type.setdefault(int(uc.type_of_atom[ia]), (off, nbf))
        for it, t in enumerate(uc.atom_types):
            if ctx.beta.qmat is not None and it in first_block_of_type:
                off, nbf = first_block_of_type[it]
                qxi[it] = np.asarray(
                    ctx.beta.qmat[off : off + nbf, off : off + nbf]
                )
            if not t.spin_orbit:
                continue
            f = f_coefficients(t)
            meta = [
                (ib, b.l, b.j) for ib, b in enumerate(t.beta)
                for _ in range(2 * b.l + 1)
            ]
            same_rf = np.array([[a[0] == b_[0] for b_ in meta] for a in meta])
            same_lj = np.array([[a[1:] == b_[1:] for b_ in meta] for a in meta])
            rf = np.asarray([m[0] for m in meta])
            f_by_type[it] = f
            frf_by_type[it] = f * same_rf[:, :, None, None]
            dion_xi[it] = t.d_ion[np.ix_(rf, rf)] * same_lj
            off, nbf = first_block_of_type[it]
            dion_col[it] = np.asarray(ctx.beta.dion[off : off + nbf, off : off + nbf])
        return SpinOrbitData(
            f_by_type=f_by_type,
            frf_by_type=frf_by_type,
            dion_xi=dion_xi,
            dion_collinear=dion_col,
            qxi_by_type=qxi,
            blocks=blocks,
            type_of_atom=uc.type_of_atom,
        )

    def _iter(self):
        for ia, off, nbf in self.blocks:
            it = int(self.type_of_atom[ia])
            yield ia, off, nbf, it

    def d_blocks(self, d0, db) -> np.ndarray:
        """[4, nbeta_tot, nbeta_tot] complex blocks (uu, dd, ud, du).

        d0: screened scalar D (bare dion + augmentation integral);
        db: [D(Bx), D(By), D(Bz)] augmentation integrals (Nones if no
        augmentation). SO atom blocks follow Eq. 19 verbatim; others keep
        ops/spinor.py::spin_blocks_from_components' sigma.B assembly."""
        plain = [torch.as_tensor(np.asarray(d0))]
        plain += [torch.zeros_like(plain[0]) if db[c] is None
                  else torch.as_tensor(np.asarray(db[c])) for c in (2, 0, 1)]
        out = spin_blocks_from_components(*plain).numpy()
        # storage map for the (sigma, sigma') element in OUR (uu, dd, ud,
        # du) slot order: (0,1) -> ud=2, (1,0) -> du=3. NOTE this is the
        # TRANSPOSE of the reference's s_idx {{0,3},{2,1}}: with this
        # package's f convention (Hermitian projector f[m1,m2,s,s'] =
        # <m1 s|P_lj|m2 s'>) the congruence below yields the (sigma,
        # sigma') element directly, while the reference's f is transposed
        # in its spin slots and compensates inside its own apply. The
        # degenerate-j completeness test pins the correct mapping: only
        # the antisymmetric Pauli-y channel can tell the two apart, which
        # is why it survived until the sigma.B reduction test existed.
        s_idx = [[0, 2], [3, 1]]
        for ia, off, nbf, it in self._iter():
            f = self.frf_by_type[it]
            if f is None:
                continue
            sl = slice(off, off + nbf)
            # augmentation components (V, Bz, Bx, By): subtract the bare
            # ionic part from d0 — it enters through its own f term below
            comp = [np.asarray(d0[sl, sl]) - self.dion_collinear[it]]
            for c in (2, 0, 1):  # (Bz, Bx, By) from db = (Bx, By, Bz)
                comp.append(
                    np.zeros((nbf, nbf)) if db[c] is None else np.asarray(db[c][sl, sl])
                )
            dso = np.zeros((4, nbf, nbf), dtype=np.complex128)
            for sig in (0, 1):
                for sigp in (0, 1):
                    acc = np.zeros((nbf, nbf), dtype=np.complex128)
                    for a in range(4):
                        for s1 in (0, 1):
                            for s2 in (0, 1):
                                p = PAULI[a][s1][s2]
                                if p == 0:
                                    continue
                                acc += p * (
                                    f[:, :, sig, s1] @ comp[a] @ f[:, :, s2, sigp]
                                )
                    dso[s_idx[sig][sigp]] = acc
            # ionic contribution on same-(l, j) pairs (cross-radial allowed)
            fi = self.f_by_type[it]
            di = self.dion_xi[it]
            dso[0] += di * fi[:, :, 0, 0]
            dso[1] += di * fi[:, :, 1, 1]
            dso[2] += di * fi[:, :, 0, 1]
            dso[3] += di * fi[:, :, 1, 0]
            for c in range(4):
                out[c, sl, sl] = dso[c]
        return out

    def q_blocks(self) -> np.ndarray:
        """[4, nbeta_tot, nbeta_tot] complex Q spin blocks (Eq. 18)."""
        nbt = self.blocks[-1][1] + self.blocks[-1][2]
        out = np.zeros((4, nbt, nbt), dtype=np.complex128)
        any_aug = False
        for ia, off, nbf, it in self._iter():
            sl = slice(off, off + nbf)
            q = self.qxi_by_type[it]
            f = self.frf_by_type[it]
            if q is None:
                continue
            any_aug = True
            if f is None:
                out[0, sl, sl] = q
                out[1, sl, sl] = q
                continue
            for si in (0, 1):
                for sj in (0, 1):
                    acc = np.zeros((nbf, nbf), dtype=np.complex128)
                    for s in (0, 1):
                        acc += f[:, :, sj, s] @ q @ f[:, :, s, si]
                    ind = si if si == sj else sj + 2
                    out[ind, sl, sl] = acc
        return out if any_aug else None

    def rotate_dm(self, dm3: np.ndarray) -> np.ndarray:
        """Rotate the (uu, dd, ud) spin density matrix for SO atoms:
        dm_rot^{s s'} = sum_{t t'} f^{(rf)}[:, :, s, t] dm^{t t'}
        f^{(rf)}[:, :, t', s'] (reference density.cpp:938-1000 bp1/bp2
        rotation before the gemm)."""
        out = dm3.copy()
        for ia, off, nbf, it in self._iter():
            f = self.frf_by_type[it]
            if f is None:
                continue
            sl = slice(off, off + nbf)
            uu, dd, ud = dm3[0, sl, sl], dm3[1, sl, sl], dm3[2, sl, sl]
            dm = [[uu, ud], [ud.conj().T, dd]]
            rot = {}
            for sig in (0, 1):
                for sigp in (0, 1):
                    acc = np.zeros((nbf, nbf), dtype=np.complex128)
                    for s in (0, 1):
                        for s2 in (0, 1):
                            acc += f[:, :, sig, s] @ dm[s][s2] @ f[:, :, s2, sigp]
                    rot[(sig, sigp)] = acc
            out[0, sl, sl] = rot[(0, 0)]
            out[1, sl, sl] = rot[(1, 1)]
            out[2, sl, sl] = rot[(0, 1)]
        return out
