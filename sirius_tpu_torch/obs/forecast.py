"""Convergence analytics for SCF trajectories (sirius_tpu/obs/forecast.py's
estimators; its replay over recorded event streams comes with the port's
obs package, ROADMAP queue 1 item 12).

Pure-host, numpy-only estimators fed by the per-iteration scalar record
that the SCF loop already reads back (no extra device work, no extra
transfers):

``fit_decay``
    log-linear least-squares fit of the residual tail -> geometric decay
    rate per iteration (rate < 1 means contraction).
``ConvergenceForecaster``
    incremental wrapper: feed it ``(it, rms, e_total)`` each iteration and
    read the decay rate, an iterations-to-converge forecast against the
    deck's ``density_tol`` and a divergence early-warning score in [0, 1].

Consumers: dft/recovery.py (proactive snapshot + backoff BEFORE the
non-finite sentinel trips). The JAX package's events, gauges and deadline
triage read it too; those come with the port's obs and serve packages
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ConvergenceForecaster", "fit_decay"]


def fit_decay(values) -> float:
    """Geometric per-iteration decay rate of a residual tail.

    Least-squares slope of log10(values) against the sample index,
    returned as ``10**slope``: 0.5 means the residual halves every
    iteration, 1.0 is a stall, >1 is growth.  Non-finite and non-positive
    entries are dropped (they carry no decay information); with fewer than
    two usable points the rate is undefined and NaN is returned.
    """
    v = np.asarray(list(values), dtype=np.float64)
    idx = np.arange(v.size, dtype=np.float64)
    ok = np.isfinite(v) & (v > 0.0)
    if int(ok.sum()) < 2:
        return float("nan")
    x, y = idx[ok], np.log10(v[ok])
    xm, ym = x.mean(), y.mean()
    den = float(np.sum((x - xm) ** 2))
    if den == 0.0:
        return float("nan")
    slope = float(np.sum((x - xm) * (y - ym))) / den
    return float(10.0 ** slope)


class ConvergenceForecaster:
    """Incremental decay-rate / iterations-to-converge / early-warning
    estimator over a single SCF trajectory.

    The fit window is deliberately short (``window`` trailing iterations):
    SCF convergence is piecewise-geometric — mixer history build-up,
    tolerance scheduling and recovery rollbacks all change the contraction
    factor mid-run — so a global fit would average incompatible regimes.
    """

    def __init__(self, density_tol: float, window: int = 8,
                 min_history: int = 3):
        self.tol = float(density_tol)
        self.window = max(2, int(window))
        self.min_history = max(1, int(min_history))
        self._its: list[int] = []
        self._rms: list[float] = []
        self._etot: list[float] = []
        # consecutive iterations with rms strictly above the previous one
        self._growth_streak = 0

    # ---- feeding -------------------------------------------------------

    def update(self, it: int, rms: float, e_total: float | None = None):
        """Record one iteration; returns the post-update snapshot dict
        (same shape as :meth:`snapshot`)."""
        rms = float(rms)
        prev = self._rms[-1] if self._rms else None
        if (prev is not None and math.isfinite(rms) and math.isfinite(prev)
                and rms > prev):
            self._growth_streak += 1
        else:
            self._growth_streak = 0
        self._its.append(int(it))
        self._rms.append(rms)
        self._etot.append(float(e_total) if e_total is not None else math.nan)
        return self.snapshot()

    def reset(self) -> None:
        """Drop all history (recovery rollback: the poisoned trajectory
        must not contaminate the post-rollback fit)."""
        self._its.clear()
        self._rms.clear()
        self._etot.clear()
        self._growth_streak = 0

    # ---- estimators ----------------------------------------------------

    def _tail(self) -> list[float]:
        return self._rms[-self.window:]

    def decay_rate(self) -> float:
        """Fitted geometric decay rate over the trailing window (NaN until
        two usable samples exist)."""
        return fit_decay(self._tail())

    def forecast_remaining(self) -> int | None:
        """Iterations still needed to reach ``density_tol``, extrapolating
        the fitted decay; None when no contraction is measurable (stalled,
        growing, or not enough history)."""
        if not self._rms:
            return None
        last = self._rms[-1]
        if math.isfinite(last) and last <= self.tol:
            return 0
        rate = self.decay_rate()
        if (self.tol <= 0.0
                or not math.isfinite(rate) or rate <= 0.0 or rate >= 1.0
                or not math.isfinite(last) or last <= 0.0):
            return None
        n = math.log(self.tol / last) / math.log(rate)
        return max(1, int(math.ceil(n)))

    def forecast_total(self) -> int | None:
        """Forecast of the final 1-based iteration count (current
        iteration + remaining); None when remaining is unforecastable."""
        rem = self.forecast_remaining()
        if rem is None or not self._its:
            return None
        return self._its[-1] + rem

    def warning_score(self) -> float:
        """Divergence early-warning score in [0, 1].

        1.0 before ``min_history`` samples exist — a trajectory with no
        contraction evidence yet has not earned trust, which is exactly
        what makes the score a useful proactive-snapshot trigger in the
        first iterations where fault-injection tests strike.  After that:
        >= 0.6 when the fitted rate says stall-or-growth, pushed towards
        1.0 by a sustained growth streak scaled by how many decades the
        residual climbed above its recent minimum.  A clean geometric
        contraction scores ~0.
        """
        if not self._rms:
            return 1.0
        last = self._rms[-1]
        if not math.isfinite(last):
            return 1.0
        if len(self._rms) < self.min_history:
            return 1.0
        rate = self.decay_rate()
        score = 0.0
        if not math.isfinite(rate) or rate >= 1.0:
            score = 0.6
        elif rate > 0.9:
            # near-stall: small positive score, never enough to fire alone
            score = (rate - 0.9) * 4.0
        if self._growth_streak >= 2:
            tail = [r for r in self._tail()
                    if math.isfinite(r) and r > 0.0]
            rmin = min(tail) if tail else last
            decades = math.log10(max(last / max(rmin, 1e-300), 1.0))
            score = max(score, min(1.0, 0.5 + 0.25 * decades))
        return float(min(1.0, score))

    def snapshot(self) -> dict:
        """One dict per iteration for events/tests: everything the scf
        loop emits in its ``scf_forecast`` event."""
        rate = self.decay_rate()
        rem = self.forecast_remaining()
        return {
            "it": self._its[-1] if self._its else None,
            "rms": self._rms[-1] if self._rms else None,
            "decay_rate": None if not math.isfinite(rate) else rate,
            "forecast_remaining": rem,
            "forecast_total": self.forecast_total(),
            "warning": self.warning_score(),
            "growth_streak": self._growth_streak,
            "n_history": len(self._rms),
        }
