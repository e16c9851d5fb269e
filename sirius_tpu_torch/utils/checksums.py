"""Env-gated per-stage scalar checksums (SURVEY §5; reference
env::print_checksum() + print_checksum() calls through the SCF chain,
src/core/env/env.hpp): a cheap tripwire for cross-mesh nondeterminism.

Enable with SIRIUS_TPU_PRINT_CHECKSUM=1. Each call prints one line
`[checksum] <tag>: <value>` and records the value so a test (or a
debugging session) can compare the single-device and mesh-sharded
trajectories stage by stage. A copy of sirius_tpu/utils/checksums.py that
also takes torch tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np

_records: dict[str, list] = {}


def enabled() -> bool:
    return os.environ.get("SIRIUS_TPU_PRINT_CHECKSUM", "") == "1"


def checksum(tag: str, arr) -> None:
    """Record + print the plain sum of `arr` under `tag` (no-op unless
    SIRIUS_TPU_PRINT_CHECKSUM=1)."""
    if not enabled():
        return
    a = arr.cpu().numpy() if hasattr(arr, "cpu") else np.asarray(arr)
    v = complex(np.sum(a)) if np.iscomplexobj(a) else float(np.sum(a))
    _records.setdefault(tag, []).append(v)
    print(f"[checksum] {tag}: {v!r}", flush=True)


def records() -> dict[str, list]:
    return _records


def reset() -> None:
    _records.clear()
