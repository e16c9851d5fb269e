"""Spherical Bessel functions j_l.

Host-side tables use scipy; a recurrence implementation (stable downward
recurrence) is provided over numpy arrays for all l at once.
Reference: src/core/sf/sbessel.hpp (GSL-based Spherical_Bessel_functions).
"""

from __future__ import annotations

import numpy as np
import scipy.special


def spherical_jn(l: int, x: np.ndarray) -> np.ndarray:
    """Host (numpy) spherical Bessel j_l(x)."""
    return scipy.special.spherical_jn(l, np.asarray(x, dtype=np.float64))


def spherical_jn_recurrence(lmax: int, x: np.ndarray) -> np.ndarray:
    """j_l(x) for all l in [0, lmax]; returns [..., lmax+1].

    Hybrid scheme: upward recurrence j_{l+1} = (2l+1)/x j_l - j_{l-1} in the
    oscillatory region x > l (stable there), Miller's normalized downward
    recurrence from L = lmax + 16 for x <= l (where upward is unstable), and
    the leading series for x -> 0. Verified against scipy to ~1e-12 in
    the JAX package; the port holds it to that version in
    tests/test_torch_context.py.
    """
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    # work on |x| throughout; parity j_l(-x) = (-1)^l j_l(x) is applied at
    # the end so every branch is consistently signed
    xs = np.where(ax < 1e-4, 1e-4, ax)  # clamped argument for recurrences
    # --- upward pass (valid where |x| > l) ---
    up = [np.sinc(ax / np.pi)]  # j0 = sin x / x with correct x->0 limit
    if lmax >= 1:
        up.append(np.sin(xs) / xs**2 - np.cos(xs) / xs)
    for l in range(1, lmax):
        up.append((2 * l + 1) / xs * up[l] - up[l - 1])
    up = np.stack(up, axis=-1)
    # --- downward (Miller) pass, normalized by sum_l (2l+1) j_l^2 = 1 ---
    # (normalizing against j0 alone cancels catastrophically near j0's zeros)
    lstart = lmax + 16
    fp = np.zeros_like(xs)
    # seed at the true magnitude j_lstart ~ x^l/(2l+1)!! (computed in log
    # space, clipped to stay normal) so the unnormalized trial values reach
    # O(1) at l=0 and the norm accumulator cannot overflow for any (lmax, x)
    log_dfact = float(np.sum(np.log(np.arange(2 * lstart + 1, 0, -2, dtype=np.float64))))
    fc = np.exp(np.clip(lstart * np.log(xs) - log_dfact, -290.0, 0.0))
    norm = (2 * lstart + 3) * fc * fc
    down = [None] * (lmax + 1)
    for l in range(lstart, -1, -1):
        fm = (2 * l + 3) / xs * fc - fp
        norm = norm + (2 * l + 1) * fm * fm
        if l <= lmax:
            down[l] = fm
        fp, fc = fc, fm
    down = np.stack(down, axis=-1)
    # downward start (positive) fixes the overall sign: j_lstart(x) > 0 for
    # x < lstart, which the x <= l selection region guarantees.
    down = down / np.sqrt(norm)[..., None]
    ls = np.arange(lmax + 1, dtype=x.dtype)
    out = np.where(ax[..., None] > ls + 1.0, up, down)
    # --- series near the origin: j_l ~ x^l/(2l+1)!! (1 - x^2/(2(2l+3))) ---
    dfact = np.array(
        [float(np.prod(np.arange(2 * l + 1, 0, -2, dtype=np.float64))) for l in range(lmax + 1)]
    )
    series = ax[..., None] ** ls / dfact * (1.0 - ax[..., None] ** 2 / (2.0 * (2 * ls + 3)))
    out = np.where(ax[..., None] < 1e-4, series, out)
    parity = np.where((x[..., None] < 0) & (ls.astype(np.int32) % 2 == 1), -1.0, 1.0)
    return out * parity
