"""Crystal symmetry, found natively (no spglib dependency).

The reference delegates to spglib (src/symmetry/crystal_symmetry.cpp:210
spg_get_dataset) and then filters magnetic symmetry. Here the space-group
operations are found directly with the textbook algorithm spglib itself uses:

  1. candidate rotations = integer matrices W (fractional basis) with
     det W = +-1 that preserve the lattice metric  W M W^T = M,  M = A A^T;
  2. for each W, candidate translations t = x_j - W x_0 against atoms of the
     least-abundant species; (W, t) is kept if it permutes every atom onto an
     atom of the same species (mod lattice) within tolerance;
  3. collinear/non-collinear magnetic structures filter ops that do not
     preserve the initial moments (reference magnetization symmetry check).

Each op also records the induced atom permutation (needed to symmetrize
forces and on-site matrices) and the integer reciprocal rotation
W_k = (W^{-1})^T acting on fractional k / G vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_TOL = 1e-6
_ROTATION_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class SymmetryOp:
    w: np.ndarray  # (3,3) int rotation, fractional (real space): x' = W x + t
    t: np.ndarray  # (3,) translation, fractional
    perm: np.ndarray  # (natom,) atom a maps onto atom perm[a]
    w_k: np.ndarray  # (3,3) int reciprocal rotation (W^{-1})^T
    rot_cart: np.ndarray  # (3,3) cartesian rotation matrix
    # collinear spin action (reference spin_rotation S(2,2)): magnetization
    # is an axial vector, m'_z = det(R) R_zz m_z = spin_sign * m_z. +-1 for
    # ops kept by the magnetic filter; +1 for nonmagnetic systems. AFM
    # sublattice-swap ops carry -1 — symmetrizing m_z without it averages
    # the staggered field to zero (NiO, verification/test05).
    spin_sign: float = 1.0


def _lattice_rotations(lattice: np.ndarray) -> np.ndarray:
    """All integer fractional rotations preserving the metric (point group of
    the empty lattice, up to 48 ops for cubic).

    Returned matrices are COLUMN-acting on fractional coordinates
    (x' = W x): basis rows transform as A' = W^T A, so the metric condition
    is W^T (A A^T) W = A A^T."""
    m = lattice @ lattice.T
    scale = max(1.0, np.abs(m).max())
    key = hash(np.round(m / scale, 9).tobytes())
    cached = _ROTATION_CACHE.get(key)
    if cached is not None:
        return cached
    # per-column candidates first: column j of W maps basis direction e_j to
    # an integer vector c with c^T M c = M_jj (norm preservation) — typically
    # a few dozen candidates each — then assemble triples and check the
    # off-diagonal metric entries and |det| = 1. Orders of magnitude cheaper
    # than enumerating all 5^9 integer matrices.
    base = np.arange(5**3, dtype=np.int64)
    cols = np.stack([(base // 5**p) % 5 - 2 for p in range(3)], axis=1)  # (125,3)
    norms = np.einsum("ni,ij,nj->n", cols, m, cols)
    cand_j = [cols[np.abs(norms - m[j, j]) < _TOL * scale] for j in range(3)]
    c0, c1, c2 = cand_j
    # pairwise off-diagonal filter before the triple product
    d01 = np.abs(np.einsum("ai,ij,bj->ab", c0, m, c1) - m[0, 1]) < _TOL * scale
    out = []
    for i0, i1 in zip(*np.nonzero(d01)):
        v0, v1 = c0[i0], c1[i1]
        ok2 = (
            (np.abs(c2 @ (m @ v0) - m[0, 2]) < _TOL * scale)
            & (np.abs(c2 @ (m @ v1) - m[1, 2]) < _TOL * scale)
        )
        for v2 in c2[ok2]:
            w = np.stack([v0, v1, v2], axis=1)  # columns
            if abs(round(np.linalg.det(w))) == 1:
                out.append(w)
    out = np.asarray(out, dtype=np.int64).reshape(-1, 3, 3)
    _ROTATION_CACHE[key] = out
    return out


def find_symmetry(
    lattice: np.ndarray,
    positions: np.ndarray,
    species: np.ndarray,
    moments: np.ndarray | None = None,
    num_mag_dims: int = 0,
    tol: float = _TOL,
) -> list[SymmetryOp]:
    positions = np.asarray(positions, dtype=np.float64)
    species = np.asarray(species)
    natom = len(positions)
    rots = _lattice_rotations(np.asarray(lattice, dtype=np.float64))
    inv_lat_t = np.linalg.inv(lattice.T)
    ops: list[SymmetryOp] = []
    # pivot species: least abundant
    counts = {s: int(np.sum(species == s)) for s in set(species.tolist())}
    pivot_s = min(counts, key=counts.get)
    pivot_atoms = np.nonzero(species == pivot_s)[0]
    x0 = positions[pivot_atoms[0]]
    for w in rots:
        wx = positions @ w.T  # (natom, 3): W x_a
        seen_t: list[np.ndarray] = []
        for j in pivot_atoms:
            t = np.mod(positions[j] - w @ x0, 1.0)
            if any(np.all(np.minimum(d := np.abs(t - ts), 1 - d) < tol) for ts in seen_t):
                continue
            mapped = np.mod(wx + t, 1.0)
            # distance to every atom, on the torus
            d = np.abs(mapped[:, None, :] - positions[None, :, :])
            d = np.minimum(d, 1.0 - d)
            match = np.all(d < tol, axis=2)  # (a, b): W x_a + t == x_b
            perm = np.full(natom, -1, dtype=np.int64)
            ok = True
            for a in range(natom):
                hits = np.nonzero(match[a])[0]
                if len(hits) != 1 or species[hits[0]] != species[a]:
                    ok = False
                    break
                perm[a] = hits[0]
            if not ok or len(set(perm.tolist())) != natom:
                continue
            rot_cart = lattice.T @ w @ inv_lat_t
            detr = np.linalg.det(rot_cart)
            spin_sign = float(np.sign(round(detr * rot_cart[2, 2]))) or 1.0
            if moments is not None and num_mag_dims > 0:
                # moments are axial vectors: m' = det(R) R m; collinear case
                # requires preservation up to the filter below
                mrot = (moments @ rot_cart.T) * detr
                if num_mag_dims == 1:
                    keep_op = np.allclose(mrot[:, 2], moments[perm][:, 2], atol=1e-4)
                    # the collinear field transforms with det(R)*R_zz; for a
                    # kept op on a magnetic system this must be exactly +-1
                    if keep_op and np.any(np.abs(moments[:, 2]) > 1e-12):
                        keep_op = abs(abs(detr * rot_cart[2, 2]) - 1.0) < 1e-6
                        spin_sign = float(np.sign(detr * rot_cart[2, 2]))
                    else:
                        # zero starting moments: the reference decouples spin
                        # from space and picks the identity spin rotation
                        # (crystal_symmetry.cpp jsym loop) — never flip the
                        # (about-to-develop) polarization with a snapped sign
                        spin_sign = 1.0
                else:
                    keep_op = np.allclose(mrot, moments[perm], atol=1e-4)
                if not keep_op:
                    continue
            w_k = np.linalg.inv(w).T.round().astype(np.int64)
            ops.append(
                SymmetryOp(
                    w=w, t=t, perm=perm, w_k=w_k, rot_cart=rot_cart,
                    spin_sign=spin_sign,
                )
            )
            seen_t.append(t)
    return ops


@dataclasses.dataclass
class CrystalSymmetry:
    ops: list[SymmetryOp]
    lattice: np.ndarray

    @staticmethod
    def find(
        lattice: np.ndarray,
        positions: np.ndarray,
        species: np.ndarray,
        moments: np.ndarray | None = None,
        num_mag_dims: int = 0,
        tol: float = _TOL,
    ) -> "CrystalSymmetry":
        return CrystalSymmetry(
            ops=find_symmetry(lattice, positions, species, moments, num_mag_dims, tol),
            lattice=np.asarray(lattice, dtype=np.float64),
        )

    @property
    def num_ops(self) -> int:
        return len(self.ops)

    @property
    def has_inversion(self) -> bool:
        return any(np.array_equal(op.w, -np.eye(3, dtype=np.int64)) for op in self.ops)
