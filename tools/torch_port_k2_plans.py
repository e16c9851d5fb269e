"""K2's time on the card under each cluster size, at the full-width shapes.

For each band-solve block of chip_smoke.py's full-width runs (16 atoms NC
and US, complex128 and complex64; 54 atoms packed real, float64 and
float32; the 16-atom spinor rows), with seeded blocks shaped like a band
solve's (S positive, H x near x), times kernels/davidson_residual.py::
davidson_residual with its plan forced to every cluster size whose slices
fit the card (1: one block a row), and prints one JSON line a (shape,
cluster): the event time of back-to-back calls, the device time of the
kernel (torch.profiler), the host time to enqueue one call, and which
cluster davidson_residual_plan picks.

    python3 tools/torch_port_k2_plans.py

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (batches, bands, ngk, block type) of the full-width band solves
SHAPES = (((8, 42, 7880), "complex128"), ((3, 42, 7880), "complex128"),
          ((3, 42, 7880), "complex64"), ((1, 129, 26469), "float64"),
          ((1, 129, 26469), "float32"), ((4, 84, 15760), "complex128"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k2_plans: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sirius_tpu_torch.kernels import build
    from sirius_tpu_torch.kernels import davidson_residual as k2

    build.build_all(("davidson_residual",))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(3)
    chosen = k2.davidson_residual_plan
    for (b, nb, ngk), name in SHAPES:
        dtype = getattr(torch, name)
        real = torch.float32 if dtype in (torch.complex64,
                                          torch.float32) else torch.float64
        eb = torch.empty((), dtype=dtype).element_size()

        def block():
            z = torch.as_tensor(rng.standard_normal((2, b, nb, ngk)),
                                device=dev)
            return (torch.complex(z[0], z[1]) if dtype.is_complex
                    else z[0]).to(dtype)

        def table(lo, hi):
            return torch.as_tensor(rng.uniform(lo, hi, (b, nb, ngk)),
                                   device=dev).to(real)

        x = block()
        sx = x * table(1.0, 2.0)
        hx = x * table(-1.0, 3.0) + 0.01 * block()
        hd = table(1.0, 3.0)[:, 0].contiguous()
        od = torch.ones_like(hd)
        args = (x, hx, sx, hd, od, torch.ones_like(hd), 1e-6)
        pick = chosen(b * nb, ngk, eb, build.sm_count(dev))["cluster"]
        for cluster in (1,) + k2.CLUSTERS:
            slice_ = -(-ngk // cluster)
            if cluster > 1 and 3 * slice_ * eb > 2 * k2.SLICE_BUDGET:
                continue  # not even one block an SM
            k2.davidson_residual_plan = (
                lambda nrows, n, e, sm, c=cluster, s=slice_: {
                    "cluster": c, "slice": s, "blocks": nrows * c,
                    "shared": 3 * s * e if c > 1 else 0})
            try:
                fn = lambda: k2.davidson_residual(*args)  # noqa: E731
                ms = cs.time_ms(fn)
                dms = cs.device_ms(fn, dev, ("residual_rows",))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn()
                host_us = (time.perf_counter() - t0) / 20 * 1e6
                torch.cuda.synchronize()
            finally:
                k2.davidson_residual_plan = chosen
            print(json.dumps({"shape": [b, nb, ngk], "dtype": name,
                              "cluster": cluster, "planned": pick,
                              "ms": ms, "device_ms": dms,
                              "host_us_per_call": host_us,
                              "nvidia_smi": smi}), flush=True)
        del x, hx, sx
    return 0


if __name__ == "__main__":
    sys.exit(main())
