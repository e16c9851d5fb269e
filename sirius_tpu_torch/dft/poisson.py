"""Hartree potential in reciprocal space (reference: potential/poisson.cpp:151,
PP-PW branch). Mirrors sirius_tpu/dft/poisson.py on tensors.

V_H(G) = 4 pi rho(G) / G^2,  V_H(0) = 0 (jellium convention; the divergent
G=0 pieces of Hartree/local/Ewald cancel in the total energy, tracked term
by term exactly like the reference).
E_H = Omega/2 sum_G |rho(G)|^2 4 pi / G^2.
"""

from __future__ import annotations

import math

import torch


def hartree_potential_g(rho_g: torch.Tensor, glen2: torch.Tensor) -> torch.Tensor:
    """rho(G) -> V_H(G) on the same G set (G=0 first, set to zero)."""
    nonzero = glen2 > 1e-12
    g2 = torch.where(nonzero, glen2, 1.0)
    v = 4.0 * math.pi * rho_g / g2
    return torch.where(nonzero, v, torch.zeros((), dtype=v.dtype, device=v.device))


def hartree_energy(rho_g: torch.Tensor, vha_g: torch.Tensor, omega: float) -> torch.Tensor:
    """E_H = (Omega/2) sum_G rho*(G) V_H(G) (real by construction)."""
    return 0.5 * omega * torch.sum(torch.conj(rho_g) * vha_g).real
