"""SCF supervision & recovery: divergence sentinels and a backoff ladder.

A copy of sirius_tpu/dft/recovery.py: the same sentinels, ladders,
directives, history records and diagnostic. The JAX package also counts
each rung and abort in its obs metrics and emits a "recovery" event; the
port's records are result["recovery"] (dft/scf.py), and the counters and
events come with its obs package (ROADMAP queue 1 item 12).

The reference answers SCF divergence with restartable ground states and
"robust" direct-minimization solvers; long device-resident loops add
preemption and silent NaN propagation on top (PAPERS.md: numerical-failure
handling and checkpoint/restart are prerequisites for multi-hour runs).
Previously run_scf raised a bare FloatingPointError at three sites (non-finite fused
scalars, non-finite eigen/mixed vectors, non-finite potential) and lost
the whole run; with control.scf_supervision off it still does.

ScfSupervisor turns those sites into a bounded retry loop:

  sentinel fires (non-finite field, energy blow-up, RMS growing for K
  consecutive iterations, or — earlier — the forecast early-warning score
  of obs/forecast.py staying high while the residual climbs an order of
  magnitude)
    -> roll back to the last finite (x_mix, energy) snapshot
    -> escalate one rung of the backoff ladder:
         rung 0: flush Anderson/Broyden history (a poisoned history is the
                 most common divergence amplifier)
         rung 1: flush + halve beta and fall back to linear mixing
         rung 2: disable the fused device path for the remaining
                 iterations (host path re-checks every field per iteration
                 and runs the band solve under supervision)
         rung 3+ (or recovery budget exhausted): abort with ScfAbortError
                 carrying a structured diagnostic (sentinel, iteration,
                 last-good energies, ladder history)

run_scf owns the actual state mutation (restoring x_mix, rebuilding the
potential and the fused program); the supervisor owns detection, the
snapshot payload, escalation bookkeeping, and the diagnostic dump.

Device OOM rides a SEPARATE ladder (``OOM_LADDER``): a device
out-of-memory error (classified by utils/devfail.py, injected by the
``device.oom`` fault site) means the memory plan is wrong, not the
physics — so instead of flushing mixer history the rungs shrink the
memory footprint, each journaled/metered like a divergence rung and
resumed from the last snapshot rather than restarting:

  rung 0: shrink beta_chunk_budget_bytes (and halve beta_chunk_size) so
          the chunked-projector path engages, or engages with smaller
          chunks; repeatable while the chunks can still halve
  rung 1: force the chunked beta path outright (when the deck is
          eligible: single k, ns=1, no Hubbard/PAW/mGGA)
  rung 2: disable device_scf — host fallback, smallest resident footprint
  rung 3+ (or recovery budget exhausted, or no applicable rung): abort —
          the serving layer then retries the job with the same rungs
          pre-applied via devfail.apply_oom_hint

Inapplicable rungs are skipped (a host-path run has no device_scf to
disable; a multi-k deck cannot chunk): the ladder escalates to the first
rung that actually changes the memory plan.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from sirius_tpu_torch.obs.forecast import ConvergenceForecaster

# ladder rung -> human-readable action (diagnostic / log strings)
LADDER = (
    "flush_history",
    "halve_beta_linear",
    "disable_device_scf",
    "abort",
)

# the device-OOM degradation ladder (sentinel "device_oom"): memory-plan
# rungs, not numerics rungs — see the module docstring
OOM_LADDER = (
    "shrink_beta_budget",
    "force_beta_chunked",
    "disable_device_scf",
    "abort",
)


class ScfAbortError(FloatingPointError):
    """SCF diverged beyond the recovery ladder. Subclasses
    FloatingPointError so callers of the previous fatal behaviour keep
    catching it; .diagnostic holds the structured dump."""

    def __init__(self, message: str, diagnostic: dict):
        super().__init__(message)
        self.diagnostic = diagnostic


@dataclasses.dataclass
class RecoveryDirective:
    """What run_scf must do after a rollback, one ladder escalation."""

    rung: int
    flush_history: bool = False
    beta: float | None = None  # new mixer beta (None = keep)
    kind: str | None = None  # new mixer kind (None = keep)
    disable_device: bool = False
    # OOM-ladder rungs (sentinel "device_oom"): shrink the chunked-beta
    # engagement budget / halve the chunk size, or force the chunked path
    shrink_beta_budget: bool = False
    force_beta_chunked: bool = False


class ScfSupervisor:
    """Watches per-iteration scalars, keeps the last finite snapshot, and
    hands out ladder directives when a sentinel fires."""

    def __init__(self, control, mixer_beta: float, mixer_kind: str,
                 deck_label: str = "", density_tol: float | None = None):
        self.enabled = bool(getattr(control, "scf_supervision", True))
        self.max_recoveries = int(getattr(control, "max_recoveries", 3))
        self.rms_divergence_iters = int(
            getattr(control, "rms_divergence_iters", 8))
        self.energy_blowup_tol = float(
            getattr(control, "energy_blowup_tol", 1e4))
        self.diag_dump = str(getattr(control, "diag_dump", ""))
        # convergence analytics (obs/forecast.py): early-warning score +
        # iterations-to-converge forecast, fed the same observe() scalars
        self.forecast_enabled = bool(
            getattr(control, "forecast_enabled", True))
        self.forecast_warning_threshold = float(
            getattr(control, "forecast_warning_threshold", 0.5))
        self.forecast_backoff_ratio = float(
            getattr(control, "forecast_backoff_ratio", 10.0))
        # the forecast sentinel acts EARLIER than rms_divergence (half the
        # streak) but never instantly: a floor of 3 keeps one bad Anderson
        # step from costing a rollback
        self.forecast_backoff_iters = (
            int(getattr(control, "forecast_backoff_iters", 0))
            or max(3, self.rms_divergence_iters // 2))
        self.forecaster = ConvergenceForecaster(
            density_tol if density_tol is not None else 0.0)
        self._fc_streak = 0
        self._fc_start_rms: float | None = None
        self._fc_snap: dict | None = None
        self.deck_label = deck_label
        self.beta0 = float(mixer_beta)
        self.kind0 = str(mixer_kind)
        self.rung = 0
        self.oom_rung = 0  # separate pointer into OOM_LADDER
        self.recoveries = 0
        self.history: list[dict] = []  # one entry per recovery event
        # rollback payload: dict set by run_scf via snapshot()
        self._snap: dict | None = None
        self._rms_streak = 0
        self._streak_start_rms = None
        self._e_prev = None
        self._etot_tail: list[float] = []
        self._rms_tail: list[float] = []

    # -- snapshot ---------------------------------------------------------

    def snapshot(self, it: int, payload: dict) -> None:
        """Record the last-known-finite state. `payload` must contain
        everything run_scf needs to roll back (at minimum a host copy of
        the packed mixed vector under 'x_mix'); ownership transfers here —
        pass copies."""
        self._snap = {"it": it, **payload}

    @property
    def has_snapshot(self) -> bool:
        return self._snap is not None

    @property
    def snap(self) -> dict:
        if self._snap is None:
            raise RuntimeError("no snapshot recorded")
        return self._snap

    # -- sentinels --------------------------------------------------------

    def observe(self, it: int, rms: float, e_total: float) -> str | None:
        """Feed one finished iteration's scalars; returns the sentinel name
        if a soft-divergence condition fired, else None. (Hard non-finite
        sentinels are reported directly via recover().)"""
        self._etot_tail = (self._etot_tail + [float(e_total)])[-8:]
        self._rms_tail = (self._rms_tail + [float(rms)])[-8:]
        self._fc_snap = self.forecaster.update(it, rms, e_total)
        if not self.enabled:
            self._e_prev = e_total
            return None
        if self._e_prev is not None and np.isfinite(e_total) and np.isfinite(
                self._e_prev):
            if abs(e_total - self._e_prev) > self.energy_blowup_tol:
                self._e_prev = e_total
                return "energy_blowup"
        self._e_prev = e_total
        # RMS divergence: K consecutive growing iterations AND an order of
        # magnitude above where the streak started (plain non-monotone
        # Anderson steps must not trip it)
        if self._rms_tail[:-1] and rms > self._rms_tail[-2]:
            if self._rms_streak == 0:
                self._streak_start_rms = self._rms_tail[-2]
            self._rms_streak += 1
        else:
            self._rms_streak = 0
            self._streak_start_rms = None
        if (self._rms_streak >= self.rms_divergence_iters
                and self._streak_start_rms is not None
                and rms > 10.0 * max(self._streak_start_rms, 1e-300)):
            self._rms_streak = 0
            self._streak_start_rms = None
            return "rms_divergence"
        # forecast early warning (obs/forecast.py): backoff BEFORE the
        # non-finite/rms sentinels can trip. A separate streak from the
        # rms sentinel above: that one counts monotone growth, this one
        # counts sustained high warning scores — sharing state would
        # change the rms sentinel's firing pattern. The 10x-above-streak-
        # start guard keeps the mandatory early-run warnings (score 1.0
        # until the forecaster has min_history samples) from ever costing
        # a rollback on a healthy trajectory.
        if self.forecast_enabled:
            if self._fc_snap["warning"] >= self.forecast_warning_threshold:
                if self._fc_streak == 0:
                    self._fc_start_rms = float(rms)
                self._fc_streak += 1
            else:
                self._fc_streak = 0
                self._fc_start_rms = None
            if (self._fc_streak >= self.forecast_backoff_iters
                    and self._fc_start_rms is not None
                    and np.isfinite(rms)
                    and rms > self.forecast_backoff_ratio
                    * max(self._fc_start_rms, 1e-300)):
                self._fc_streak = 0
                self._fc_start_rms = None
                return "forecast_divergence"
        return None

    def should_snapshot(self) -> bool:
        """Proactive-snapshot trigger: True while the early-warning score
        is at or above the threshold (including the first iterations,
        where no contraction evidence exists yet). run_scf ORs this into
        its fused-path snapshot cadence so a rollback after an early fault
        lands on the newest trusted iterate instead of one up to
        snapshot_every iterations stale."""
        return (self.enabled and self.forecast_enabled
                and self._fc_snap is not None
                and self._fc_snap["warning"]
                >= self.forecast_warning_threshold)

    def forecast_snapshot(self) -> dict | None:
        """The forecaster's view after the last observe() (obs/forecast.py
        snapshot dict); None before the first iteration."""
        return self._fc_snap

    def inject_warning(self, score: float = 1.0) -> None:
        """Force the last forecast snapshot's early-warning score (fault
        site scf.forecast_misfire): exercises the proactive-snapshot and
        deadline-infeasibility consumers without a real divergence. The
        remaining-iterations forecast is dropped alongside — a run that
        warrants maximum warning has no credible convergence estimate."""
        if self._fc_snap is None:
            self._fc_snap = self.forecaster.snapshot()
        self._fc_snap = dict(
            self._fc_snap, warning=float(score),
            forecast_remaining=None, forecast_total=None,
        )

    def reset_trend(self) -> None:
        """Clear soft-sentinel trend state after a rollback (the restored
        iterate restarts the energy/rms trajectory — the poisoned tail
        must not contaminate the post-rollback decay fit either)."""
        self._rms_streak = 0
        self._streak_start_rms = None
        self._e_prev = None
        self._fc_streak = 0
        self._fc_start_rms = None
        self._fc_snap = None
        self.forecaster.reset()

    # -- recovery ---------------------------------------------------------

    def recover(self, sentinel: str, it: int, detail: str = "",
                state: dict | None = None) -> RecoveryDirective:
        """A sentinel fired at iteration `it`. Escalate one ladder rung and
        return the directive; raises ScfAbortError when the ladder (or the
        recovery budget, or the absence of any snapshot) is exhausted.

        The "device_oom" sentinel routes to the OOM degradation ladder
        (`state` must then carry the memory-plan flags — see
        _recover_oom); every other sentinel takes the divergence ladder.
        """
        if sentinel == "device_oom":
            return self._recover_oom(it, detail, state)
        if (not self.enabled or self._snap is None
                or self.recoveries >= self.max_recoveries
                or self.rung >= len(LADDER) - 1):
            raise self._abort(sentinel, it, detail, state)
        rung = self.rung
        action = LADDER[rung]
        self.rung += 1
        self.recoveries += 1
        self.history.append({
            "iteration": it,
            "sentinel": sentinel,
            "detail": detail,
            "rung": rung,
            "action": action,
            "rolled_back_to": self._snap["it"],
        })
        d = RecoveryDirective(rung=rung, flush_history=True)
        if rung >= 1:
            d.beta = 0.5 * self.beta0
            d.kind = "linear"
        if rung >= 2:
            d.disable_device = True
        self.reset_trend()
        return d

    def _recover_oom(self, it: int, detail: str,
                     state: dict | None) -> RecoveryDirective:
        """Device OOM at iteration `it`: escalate to the first OOM-ladder
        rung that actually changes the memory plan, given the run's
        current path flags in `state`:

          beta_chunk_eligible  the chunked projector path can engage
                               (single k, ns=1, no Hubbard/PAW/mGGA, not
                               explicitly disabled)
          beta_chunked         the chunked path is already active
          beta_chunk_can_halve beta_chunk_size is still above the floor
          device_scf           the fused device path is active

        Rung 0 is repeatable while the chunks can still halve (a fully
        host-side, already-chunked run has no rung 1/2 left to take)."""
        st = state or {}
        eligible = bool(st.get("beta_chunk_eligible"))
        active = bool(st.get("beta_chunked"))
        can_halve = bool(st.get("beta_chunk_can_halve", True))
        device = bool(st.get("device_scf"))
        can_shrink = (eligible and not active) or (active and can_halve)
        choice = None
        for r in range(self.oom_rung, len(OOM_LADDER) - 1):
            a = OOM_LADDER[r]
            if a == "shrink_beta_budget" and can_shrink:
                choice = r
                break
            if a == "force_beta_chunked" and eligible and not active:
                choice = r
                break
            if a == "disable_device_scf" and device:
                choice = r
                break
        if choice is None and can_shrink:
            choice = 0  # fully degraded path: keep halving the chunks
        if (choice is None or not self.enabled or self._snap is None
                or self.recoveries >= self.max_recoveries):
            raise self._abort("device_oom", it, detail, state)
        action = OOM_LADDER[choice]
        self.oom_rung = max(self.oom_rung, choice + 1)
        self.recoveries += 1
        self.history.append({
            "iteration": it,
            "sentinel": "device_oom",
            "detail": detail,
            "ladder": "oom",
            "rung": choice,
            "action": action,
            "rolled_back_to": self._snap["it"],
        })
        d = RecoveryDirective(rung=choice)
        if action == "shrink_beta_budget":
            d.shrink_beta_budget = True
        elif action == "force_beta_chunked":
            d.force_beta_chunked = True
        elif action == "disable_device_scf":
            d.disable_device = True
        self.reset_trend()
        return d

    def _abort(self, sentinel: str, it: int, detail: str,
               state: dict | None) -> ScfAbortError:
        diag = self.diagnostic(sentinel, it, detail, state)
        if self.diag_dump:
            try:
                with open(self.diag_dump, "w") as f:
                    json.dump(diag, f, indent=2, default=str)
            except OSError:
                pass
        last_good = self._snap["it"] if self._snap is not None else None
        return ScfAbortError(
            f"SCF aborted at iteration {it}: sentinel '{sentinel}' fired "
            f"after {self.recoveries} recoveries "
            f"(last good iteration: {last_good})"
            + (f"; {detail}" if detail else ""),
            diag,
        )

    def diagnostic(self, sentinel: str, it: int, detail: str = "",
                   state: dict | None = None) -> dict:
        diag = {
            "sentinel": sentinel,
            "iteration": it,
            "deck": self.deck_label,
            "recoveries": self.recoveries,
            "rung": self.rung,
            "oom_rung": self.oom_rung,
            "ladder_history": list(self.history),
            "etot_tail": list(self._etot_tail),
            "rms_tail": list(self._rms_tail),
            "last_good_iteration": (
                self._snap["it"] if self._snap is not None else None),
            "last_good_energy": (
                self._snap.get("e_total") if self._snap is not None
                else None),
            "mixer_beta0": self.beta0,
            "mixer_kind0": self.kind0,
            "detail": detail,
            "forecast": self._fc_snap,
        }
        if state:
            diag.update(state)
        return diag
