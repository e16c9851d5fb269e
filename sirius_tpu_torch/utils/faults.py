"""Deterministic fault injection for the SCF supervision/recovery machinery
(dft/recovery.py). A copy of sirius_tpu/utils/faults.py: the same sites,
plan grammar and SIRIUS_TPU_FAULTS variable; corrupt takes torch tensors
and the device sites raise CUDA's error texts. The port wires the scf.*,
checkpoint.before_rename and device.oom / device.lost sites; the others
stay in the registry for the modules of ROADMAP queue 1 items 9 and 12.

Every recovery branch — mixer-history flush, beta backoff, host fallback,
checkpoint-interrupted-save, resume-after-kill — must be drivable from a
test without waiting for a real divergence or a real preemption. A fault
plan arms named sites at specific iterations; the instrumented code calls
the hooks below, which are no-ops when nothing is armed (the common case:
one dict lookup against an empty plan).

Sites currently wired:
  scf.density        corrupt the freshly accumulated density (host or fused)
  scf.potential      corrupt the generated effective potential
  scf.evals          corrupt the band-solve eigenvalues
  scf.band_stagnate  force the band-solve health check to report stagnation
  scf.forecast_misfire
                     force the convergence forecaster's early-warning
                     score to maximum at one iteration (a deliberately
                     wrong forecast): drives the proactive-snapshot and
                     deadline-infeasibility paths deterministically, and
                     pins that a misfire alone never costs a recovery
  scf.autosave_kill  die (SimulatedKill or hard exit) right after an autosave
  md.autosave_kill   die right after an MD trajectory checkpoint (md/driver)
  checkpoint.before_rename  die inside save_state between the temp-file
                            write and the atomic rename
  serve.worker_crash kill a serve slice-worker thread mid-job (WorkerCrash
                     escapes the scheduler's catch-all; the supervisor
                     watchdog must respawn the slice) — ``iteration`` is
                     the job attempt index (0-based)
  serve.job_hang     make a serve job attempt hang on its worker instead
                     of running, until the watchdog abandons it —
                     ``iteration`` is the job attempt index
  serve.journal_torn tear the next job-journal append mid-line (partial
                     write, no newline, no fsync — the on-disk state a
                     crash inside write() leaves) — ``iteration`` is the
                     journal's append sequence number
  campaign.node_fail fail a campaign node's attempt in the scheduler
                     before its SCF starts (``raise`` preempts and
                     retries; exhausting retries exercises the
                     SKIPPED_UPSTREAM cascade to its children) —
                     ``iteration`` is the job attempt index (0-based)
  campaign.handoff_corrupt
                     corrupt the parent-handoff density as the child
                     loads it; the child must detect the damage and
                     fall back to a cold start instead of failing
                     (``iteration`` 0, fires once per armed count)
  fleet.lease_lost   make a fleet lease renewal report the lease lost
                     (the deterministic stand-in for an expiry takeover
                     after this engine stalled): the engine abandons the
                     job to its new owner, discarding any late result —
                     ``iteration`` is the FleetDir renew sequence number
  fleet.store_corrupt
                     tear the next result-store sidecar write (present
                     but unparseable record-valid marker — the state a
                     crash between the npz and sidecar renames leaves);
                     readers must treat it as a miss and recompute —
                     ``iteration`` is the store's put sequence number
  device.oom         synthesize a device out-of-memory error at the start
                     of the SCF iteration (``fire``); run_scf routes it
                     through the
                     supervisor's OOM degradation ladder
                     (utils/devfail.py classifies it as "oom")
  device.lost        synthesize a lost-device error at the same point;
                     it escapes run_scf to the serving layer,
                     which degrades the slice, shrinks its mesh to the
                     surviving devices, and resumes from autosave
                     (classified "device_lost")
  device.straggler   flag site: from the armed iteration on, run_scf's
                     iterations are artificially slowed so the straggler
                     watchdog (per-iteration wall vs the obs/costs.py
                     model and the run's healthy baseline) preempts the
                     run at a snapshot boundary

Plans are process-local (``install``/``clear``) or inherited by child
processes through the ``SIRIUS_TPU_FAULTS`` environment variable. The env
grammar is ``site@iter:action*count`` per comma-separated entry — ``@iter``
defaults to 0, ``:action`` to ``nan``, ``*count`` to 1 — e.g.::

    SIRIUS_TPU_FAULTS="scf.density@3:nan,scf.autosave_kill@5:exit"
    SIRIUS_TPU_FAULTS="serve.job_hang@0:flag*2"   # hang attempts 1 and 2

Each armed entry fires ``count`` times (default once) and then disarms, so
an injected NaN does not re-poison the state the supervisor just rolled
back. ``count`` must be >= 0 (0 arms a spec that never fires; negative
counts are rejected at validation).
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

ACTIONS = ("nan", "raise", "exit", "flag")

# The canonical fault-site registry: one entry per instrumented site in
# the tree (the docstring above documents each). sirius-lint's
# unknown-fault-site rule parses this tuple by AST, and
# tools/chaos_serve.py validates its phase specs against it, so a typo'd
# site in code or a chaos plan fails fast instead of silently never
# firing. Add the site here in the same change that wires the hook.
KNOWN_SITES = (
    "scf.density",
    "scf.potential",
    "scf.evals",
    "scf.band_stagnate",
    "scf.forecast_misfire",
    "scf.autosave_kill",
    "md.autosave_kill",
    "checkpoint.before_rename",
    "serve.worker_crash",
    "serve.job_hang",
    "serve.journal_torn",
    "campaign.node_fail",
    "campaign.handoff_corrupt",
    "fleet.lease_lost",
    "fleet.store_corrupt",
    "device.oom",
    "device.lost",
    "device.straggler",
)

# realistic runtime-error text per device fault site: the messages a real
# device-memory exhaustion (PyTorch's CUDA caching allocator) and a lost
# card (the CUDA runtime) produce, so utils/devfail.py's classifier and
# everything downstream see what production would (fire() raises these as
# RuntimeError, the base class of torch.cuda.OutOfMemoryError and of
# torch's CUDA errors; the classifier matches on the text)
_DEVICE_ERRORS = {
    "device.oom": (
        "CUDA out of memory. Tried to allocate 16.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.25 GiB is free."),
    "device.lost": (
        "CUDA error: unspecified launch failure\nCUDA kernel errors might "
        "be asynchronously reported at some other API call"),
}


class SimulatedKill(Exception):
    """In-process stand-in for SIGKILL/preemption (raised by 'raise' faults)."""


class WorkerCrash(BaseException):
    """Kills a serving worker thread (serve.worker_crash site).

    Deliberately a BaseException: the slice scheduler's catch-all
    ``except Exception`` must NOT swallow it — the point of the site is a
    worker thread dying with a job still assigned, which only the
    supervisor watchdog can recover from."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    iteration: int = 0  # SCF iteration (0-based) at which the fault arms
    action: str = "nan"
    count: int = 1  # how many times the fault fires before disarming

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action '{self.action}' (known: {ACTIONS})"
            )
        if self.count < 0:
            raise ValueError(
                f"fault count must be >= 0, got {self.count} "
                f"(site '{self.site}')"
            )


_plan: list[FaultSpec] = []
_log: list[tuple[str, int, str]] = []  # (site, iteration, action) fired
# serve slice-workers probe sites concurrently: match-and-consume must be
# atomic or a count-1 spec can fire on two threads at once
_mu = threading.Lock()


def install(specs) -> None:
    """Arm a fault plan for this process (list of FaultSpec or of
    (site, iteration[, action[, count]]) tuples)."""
    global _plan
    out = []
    for s in specs:
        if isinstance(s, FaultSpec):
            out.append(s)
        else:
            out.append(FaultSpec(*s))
    _plan = out
    _log.clear()


def clear() -> None:
    global _plan
    _plan = []
    _log.clear()


def fired() -> list[tuple[str, int, str]]:
    """(site, iteration, action) records of every fault that fired."""
    return list(_log)


def load_env(env: str | None = None) -> None:
    """Parse SIRIUS_TPU_FAULTS ('site@iter:action*count[,...]') into the
    plan. ``@iter`` defaults to 0, ``:action`` to 'nan', ``*count`` to 1."""
    env = env if env is not None else os.environ.get("SIRIUS_TPU_FAULTS", "")
    specs = []
    for tok in filter(None, (t.strip() for t in env.split(","))):
        # action first, then iteration: 'site:action' (no @iter) is legal
        head, _, action = tok.partition(":")
        site, _, itspec = head.partition("@")
        action, _, countspec = action.partition("*")
        specs.append(FaultSpec(site, int(itspec or 0), action or "nan",
                               int(countspec or 1)))
    install(specs)


def _match(site: str, iteration: int) -> FaultSpec | None:
    for s in _plan:
        if s.site == site and s.iteration == iteration and s.count > 0:
            return s
    return None


def _consume(spec: FaultSpec, iteration: int) -> str:
    spec.count -= 1
    _log.append((spec.site, iteration, spec.action))
    return spec.action


def _take(site: str, iteration: int) -> str | None:
    """Atomically match-and-consume one shot; None when nothing armed."""
    with _mu:
        spec = _match(site, iteration)
        if spec is None:
            return None
        return _consume(spec, iteration)


def armed(site: str, iteration: int = 0) -> bool:
    """True (and consumes one shot) when a 'flag' fault is armed here.
    Used for sites that alter control flow rather than data, e.g.
    scf.band_stagnate forcing the band-health check to fail."""
    return _take(site, iteration) is not None


def check(site: str, iteration: int = 0) -> None:
    """Fire a kill-style fault: 'raise' -> SimulatedKill, 'exit' -> hard
    process exit with no cleanup (the closest in-process analog of
    SIGKILL/preemption)."""
    action = _take(site, iteration)
    if action is None:
        return
    if action == "raise":
        raise SimulatedKill(f"fault '{site}' at iteration {iteration}")
    if action == "exit":
        os._exit(137)
    # nan/flag actions are meaningless here; treat as armed-and-ignored


def fire(site: str, iteration: int = 0) -> None:
    """Fire a device-fault site: raise the synthesized runtime error armed
    at (site, iteration) — the out-of-memory / lost-device text a real
    failure produces (``_DEVICE_ERRORS``), as a RuntimeError at the
    caller's launch point. 'exit' hard-exits like a card taking the
    process down; no-op when unarmed."""
    action = _take(site, iteration)
    if action is None:
        return
    if action == "exit":
        os._exit(137)
    msg = _DEVICE_ERRORS.get(site, f"INTERNAL: injected fault '{site}'")
    raise RuntimeError(f"{msg} (iteration {iteration})")


def corrupt(site: str, iteration: int, arr):
    """Return `arr` with a NaN injected in its first element when a 'nan'
    fault is armed at (site, iteration); otherwise `arr` unchanged. Works
    for numpy arrays and torch tensors on any device (a clone on that
    device with the element set there: no host round trip)."""
    action = _take(site, iteration)
    if action is None:
        return arr
    if action != "nan":
        if action == "raise":
            raise SimulatedKill(f"fault '{site}' at iteration {iteration}")
        if action == "exit":
            os._exit(137)
        return arr
    if isinstance(arr, np.ndarray):
        out = arr.copy()
        out.reshape(-1)[0] = np.nan
        return out
    # torch tensor: a contiguous clone on its device (NaN then propagates
    # through the step exactly like a real numerical blow-up would)
    import torch

    out = arr.clone(memory_format=torch.contiguous_format)
    out.view(-1)[0] = float("nan")
    return out
