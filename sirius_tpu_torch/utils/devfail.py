"""Device-failure taxonomy: classify runtime errors so the SCF loop (and,
with ROADMAP queue 1 item 12, the serving layer) can choose a recovery
policy per failure class. A copy of sirius_tpu/utils/devfail.py for CUDA.

A device-level failure surfaces in PyTorch as a ``RuntimeError`` whose
*message* says what happened: ``torch.cuda.OutOfMemoryError`` (a
``RuntimeError`` subclass) for the caching allocator's "CUDA out of
memory", and ``RuntimeError("CUDA error: ...")`` (``torch.AcceleratorError``
in newer releases) for the runtime's launch failures, illegal addresses and
lost devices. ``classify`` maps that text (walking the ``__cause__`` /
``__context__`` chain, so wrapped errors still classify) onto three
classes with distinct recovery semantics:

  ``oom``          device memory exhausted: the *program* does not fit.
                   Retrying identically re-fails identically; the only
                   useful retry changes the memory plan. In-run, the
                   ScfSupervisor's OOM degradation ladder (dft/recovery.py)
                   shrinks the projector budget / forces the chunked beta
                   path / falls back to the host path, resuming from the
                   last snapshot. At the job level a scheduler retries
                   with ``apply_oom_hint`` pre-degrading the controls.
  ``device_lost``  the card is gone or its context is poisoned (an
                   illegal address or launch failure leaves the CUDA
                   context unusable): nothing in-process can recover it;
                   resume the job from its autosave on a healthy card.
  ``transient``    everything else the runtime tags retryable (busy or
                   unavailable devices, timeouts, NCCL communicator
                   aborts): plain backoff-retry.

A ``RuntimeError`` with *no* device markers returns ``None`` — an honest
bug must keep failing the job permanently, not burn retries.

Fault injection: ``utils/faults.py`` sites ``device.oom`` /
``device.lost`` synthesize errors with CUDA's message text
(``faults.fire``), so this classifier and the ladder are exercised by the
strings a real failure produces. ``device.straggler`` is a flag site of
the straggler watchdog (see StragglerPreempt below), which comes with
ROADMAP queue 1 item 12.
"""

from __future__ import annotations

from sirius_tpu_torch.utils.faults import SimulatedKill

CLASSES = ("oom", "device_lost", "transient")

# substring markers, matched case-insensitively against the full
# exception text: PyTorch's caching allocator and the CUDA runtime's error
# strings (cudaGetErrorString), and the TPU runtime's status payloads the
# JAX package matches, so an error relayed from it classifies alike
_OOM_MARKERS = (
    "out of memory",
    "outofmemoryerror",
    "cudaerrormemoryallocation",
    "cublas_status_alloc_failed",
    "cusolver_status_alloc_failed",
    "resource_exhausted",
    "hbm space",
    "allocation failure",
    "failed to allocate",
)
_LOST_MARKERS = (
    "unspecified launch failure",
    "an illegal memory access was encountered",
    "illegal address",
    "illegal instruction",
    "misaligned address",
    "hardware stack error",
    "uncorrectable ecc error",
    "gpu has fallen off the bus",
    "cudaerrordevicesunavailable",
    "cuda-capable device(s) is/are busy or unavailable",
    "device_lost",
    "device lost",
    "device or resource lost",
    "system has halted",
    "device is in an error state",
    "hardware failure",
)
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "timed out",
    "cancelled",
    "aborted",
    "connection reset",
)
# exception type names that mark an error as backend-originated even
# when the message carries no marker (then: transient)
_BACKEND_TYPE_NAMES = ("OutOfMemoryError", "AcceleratorError",
                       "DistBackendError", "DistNetworkError")


class StragglerPreempt(SimulatedKill):
    """A straggling device (per-iteration wall far above the cost model and
    the run's own healthy baseline) preempted the run at a snapshot
    boundary. Subclasses SimulatedKill so any handler treating injected
    preemptions as retryable keeps working. The port's run_scf raises it
    once the watchdog comes with ROADMAP queue 1 item 12 (it reads the
    card's peak from obs/costs.py)."""


def _chain(exc: BaseException):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def classify(exc: BaseException | None) -> str | None:
    """Failure class of a (possibly wrapped) runtime error, or None when
    the exception is not a device failure at all."""
    if exc is None:
        return None
    backend = False
    text = []
    for e in _chain(exc):
        if type(e).__name__ in _BACKEND_TYPE_NAMES:
            backend = True
        if isinstance(e, RuntimeError) or backend:
            text.append(str(e))
    blob = " | ".join(text).lower()
    if not blob:
        return None
    if any(m in blob for m in _OOM_MARKERS):
        return "oom"
    if any(m in blob for m in _LOST_MARKERS):
        return "device_lost"
    if any(m in blob for m in _TRANSIENT_MARKERS):
        return "transient"
    # a device error type we cannot parse is still a device error: retry
    # beats permanently failing a job on e.g. a new message
    return "transient" if backend else None


def apply_oom_hint(control, level: int) -> list[str]:
    """Pre-degrade a job's controls before a retry that previously died
    of device OOM — the job-granularity mirror of the in-run degradation
    ladder (dft/recovery.py OOM_LADDER), for a scheduler to apply.

    level 1: quarter the chunked-beta engagement budget and halve the
             chunk size (smaller peak projector footprint);
    level 2: additionally force the chunked beta path;
    level 3: additionally disable device_scf (host fallback).

    Returns the list of rung names applied (for the retry detail/event).
    """
    applied = []
    lvl = int(level)
    if lvl >= 1:
        control.beta_chunk_budget_bytes = float(
            control.beta_chunk_budget_bytes) / 4.0
        control.beta_chunk_size = max(
            16, int(control.beta_chunk_size) // 2)
        applied.append("shrink_beta_budget")
    if lvl >= 2 and control.beta_chunked not in (False, "false", "off"):
        control.beta_chunked = True
        applied.append("force_beta_chunked")
    if lvl >= 3:
        control.device_scf = False
        applied.append("disable_device_scf")
    return applied
