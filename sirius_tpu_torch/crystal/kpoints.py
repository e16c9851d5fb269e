"""Monkhorst-Pack k-mesh generation and symmetry reduction to the IBZ.

Reference: K_point_set::create_k_mesh (src/k_point/k_point_set.cpp:77) via
spglib's get_irreducible_reciprocal_mesh. Here the orbit reduction is done
with exact integer arithmetic: k_i = (2 g_i + s_i) / (2 n_i) is represented
on the common denominator D = 2 lcm(n) as the integer vector
J_i = (2 g_i + s_i) L / n_i (L = lcm(n)); the reciprocal rotations
W_k = (W^{-1})^T (integer) and time reversal (-J) then act exactly, and a
rotated point participates in the reduction only when it lands back on the
grid (anisotropic grids may break some lattice ops).
"""

from __future__ import annotations

import math

import numpy as np

from sirius_tpu_torch.crystal.symmetry import CrystalSymmetry


def irreducible_kmesh(
    ngridk: list[int],
    shiftk: list[int],
    sym: CrystalSymmetry | None,
    use_symmetry: bool = True,
    time_reversal: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (kpoints [nk_irr, 3] fractional in [0,1), weights summing to 1)."""
    n = np.asarray(ngridk, dtype=np.int64)
    s = np.asarray(shiftk, dtype=np.int64)
    L = math.lcm(*[int(x) for x in n])
    D = 2 * L
    ii, jj, kk = np.meshgrid(*[np.arange(m) for m in n], indexing="ij")
    grid_i = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)  # (nk, 3)
    J = (2 * grid_i + s[None, :]) * (L // n)[None, :]  # scaled ints mod D
    nk = len(J)
    index = {tuple(v): i for i, v in enumerate(np.mod(J, D))}

    rots = [np.eye(3, dtype=np.int64)]
    if use_symmetry and sym is not None:
        rots = [op.w_k for op in sym.ops]
    if time_reversal:
        rots = rots + [-r for r in rots]

    images = np.stack([np.mod(J @ r.T, D) for r in rots])  # (nrot, nk, 3)

    rep = np.full(nk, -1, dtype=np.int64)
    weights = []
    reps = []
    for i in range(nk):
        if rep[i] >= 0:
            continue
        # BFS over the orbit of i
        orbit = {i}
        stack = [i]
        while stack:
            p = stack.pop()
            for r in range(len(rots)):
                q = index.get(tuple(images[r, p]))
                if q is not None and q not in orbit:
                    orbit.add(q)
                    stack.append(q)
        for q in orbit:
            rep[q] = i
        reps.append(i)
        weights.append(len(orbit) / nk)
    kpts = (J[np.asarray(reps)] / float(D)) % 1.0
    return kpts, np.asarray(weights)
