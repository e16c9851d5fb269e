"""Lightweight hierarchical profiler + work counters.

Replaces the reference's vendored rt_graph timers (src/core/rt_graph.hpp,
PROFILE macros in core/profiler.hpp:37-61) and the self-reported work
counters (evp_work_count / num_loc_op_applied, davidson.hpp:834,
sirius.scf.cpp:232-234). Device-side profiling composes with
torch.profiler traces; this registry covers the host-orchestrated spans and
produces the timers.json-style summary the reference emits at finalize
(run_scf's result["timers"]).

The part of sirius_tpu/utils/profiler.py the SCF uses: ``profile``,
``add_time``, ``reset_timers``, ``timer_report`` and ``counters``, per
thread, so concurrent runs keep their own spans. The JAX package's
cross-thread ``collect()`` (its serving engine's view) and the mirror of
each span into its obs metrics come with the port's serve and obs
packages (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from collections.abc import MutableMapping

_tls = threading.local()


def _local() -> dict:
    """This thread's profiler state."""
    state = getattr(_tls, "state", None)
    if state is None:
        state = {"stack": [], "timings": defaultdict(list),
                 "counters": defaultdict(float)}
        _tls.state = state
    return state


class _ThreadLocalCounters(MutableMapping):
    """Mapping facade over the calling thread's counter dict: modules do
    ``counters["x"] += 1`` / ``dict(counters)`` on per-thread storage."""

    def _d(self) -> dict:
        return _local()["counters"]

    def __getitem__(self, key):
        return self._d()[key]

    def __setitem__(self, key, value):
        self._d()[key] = value

    def __delitem__(self, key):
        del self._d()[key]

    def __iter__(self):
        return iter(dict(self._d()))

    def __len__(self):
        return len(self._d())

    def __repr__(self):
        return repr(dict(self._d()))

    def clear(self):
        self._d().clear()


counters = _ThreadLocalCounters()


@contextlib.contextmanager
def profile(name: str):
    """Nested scoped timer: with profile("scf::band_solve"): ..."""
    state = _local()
    stack = state["stack"]
    stack.append(name)
    full = "/".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        state["timings"][full].append(time.perf_counter() - t0)
        stack.pop()


def add_time(name: str, dt: float) -> None:
    """Record an externally-measured span (same registry as profile())."""
    _local()["timings"][name].append(dt)


def reset_timers() -> None:
    """Clear the calling thread's timings and counters (per-run reset)."""
    state = _local()
    state["timings"].clear()
    state["counters"].clear()


def timer_report() -> dict:
    """{name: {count, total, avg, min, max}} for the calling thread,
    sorted by total time."""
    out = {}
    for name, ts in sorted(_local()["timings"].items(),
                           key=lambda kv: -sum(kv[1])):
        out[name] = {
            "count": len(ts),
            "total": sum(ts),
            "avg": sum(ts) / len(ts),
            "min": min(ts),
            "max": max(ts),
        }
    return out
