"""Real-harmonic rotation matrices (the part of sirius_tpu/ops/hubbard.py
that the symmetrization of the beta density matrix needs; the Hubbard
correction itself comes with ROADMAP queue 1, item 8)."""

from __future__ import annotations

import numpy as np

from sirius_tpu_torch.core.sht import ylm_real

_RLM_ROT_CACHE: dict = {}


def rlm_rotation_matrix(rot_cart: np.ndarray, l: int) -> np.ndarray:
    """D with R_lm(R^-1 v) = sum_m' D[m, m'] R_lm'(v), computed by sampling
    (exact: the system is overdetermined and consistent). Cached per
    (rotation, l) — callers invoke this for every symmetry op."""
    key = (rot_cart.tobytes(), l)
    hit = _RLM_ROT_CACHE.get(key)
    if hit is not None:
        return hit
    rng = np.random.default_rng(12345)
    v = rng.standard_normal((4 * (2 * l + 1), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = ylm_real(l, v)[:, l * l : (l + 1) * (l + 1)]
    b = ylm_real(l, v @ rot_cart)[:, l * l : (l + 1) * (l + 1)]
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    _RLM_ROT_CACHE[key] = d.T
    return d.T
