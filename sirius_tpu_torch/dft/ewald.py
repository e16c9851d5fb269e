"""Ewald energy of point ions in a neutralizing electron background.

Matches the reference formula exactly (src/dft/energy.cpp ewald_energy):
  E = (2 pi / Omega) [ sum_{G!=0} |S(G)|^2 e^{-G^2/(4 a)} / G^2 - N_el^2/(4 a) ]
      - sqrt(a/pi) sum_i z_i^2
      + (1/2) sum_{i != j, T} z_i z_j erfc(sqrt(a) |r_ij + T|) / |r_ij + T|
with S(G) = sum_i z_i e^{i G r_i} and N_el = sum_i z_i (neutral cell).

The splitting parameter follows the reference's adaptive choice
(simulation_context.cpp:130): start at lambda = 1 and increase/decrease by
x2 until the G-space tail at pw_cutoff is below 1e-16.

The Ewald energy depends only on the lattice and ion positions, so it is
computed ONCE on the host at context creation (SimulationContext.e_ewald)
and hoisted out of the SCF loop entirely.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc


def ewald_lambda(pw_cutoff: float, omega: float) -> float:
    lam = 1.0
    gmax2 = pw_cutoff * pw_cutoff
    for _ in range(100):
        upper = np.exp(-gmax2 / (4.0 * lam))
        if upper < 1e-16:
            return lam
        lam *= 0.5
    return lam


def ewald_energy(
    lattice: np.ndarray,
    positions: np.ndarray,  # fractional
    charges: np.ndarray,
    gcart: np.ndarray,  # (ng, 3), G=0 first
    millers: np.ndarray,  # (ng, 3)
    pw_cutoff: float,
) -> float:
    lattice = np.asarray(lattice, dtype=np.float64)
    omega = float(abs(np.linalg.det(lattice)))
    lam = ewald_lambda(pw_cutoff, omega)
    z = np.asarray(charges, dtype=np.float64)
    nel = z.sum()

    # G-space sum (skip G=0)
    g2 = np.sum(gcart[1:] ** 2, axis=1)
    phase = np.exp(2j * np.pi * (millers[1:] @ positions.T))  # (ng-1, natom)
    s = phase @ z
    ewald_g = float(np.sum(np.abs(s) ** 2 * np.exp(-g2 / (4 * lam)) / g2))
    ewald_g -= nel * nel / (4.0 * lam)
    ewald_g *= 2.0 * np.pi / omega
    ewald_g -= np.sqrt(lam / np.pi) * np.sum(z * z)

    # real-space sum over neighbor shells within erfc cutoff
    rc = 10.0 / np.sqrt(lam)  # erfc(10) ~ 2e-45
    # translation range covering sphere rc
    inv = np.linalg.inv(lattice)
    nmax = np.ceil(rc * np.linalg.norm(inv, axis=0)).astype(int) + 1
    ts = np.array(
        np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing="ij")
    ).reshape(3, -1).T
    tcart = ts @ lattice
    pos_cart = positions @ lattice
    ewald_r = 0.0
    d = pos_cart[:, None, None, :] - pos_cart[None, :, None, :] + tcart[None, None, :, :]
    dist = np.linalg.norm(d, axis=-1)  # (na, na, nt)
    mask = (dist > 1e-10) & (dist < rc)
    zz = z[:, None, None] * z[None, :, None]
    ewald_r = 0.5 * float(np.sum(np.where(mask, zz * erfc(np.sqrt(lam) * dist) / np.where(mask, dist, 1.0), 0.0)))
    return ewald_g + ewald_r
