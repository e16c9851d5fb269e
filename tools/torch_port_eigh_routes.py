"""The routes of torch.linalg.eigh on the fp32 band solves' subspace
matrices, timed on the card, with the cuSOLVER kernels each one launches.

solvers/davidson.py runs eigh three times a Davidson step on fp32 paths:
twice in _rayleigh_ritz on the 3 nb x 3 nb pair (the overlap, then the
reduced H) and once in ortho on the nb x nb Gram matrix. At the full-width
fp32 runs of chip_smoke.py those are (dtype, batch, order):

- 54-atom packed real (full_width_gamma_us_fp32): float32, 1, 387 and 129;
- 16-atom US polished (full_width_us_fp32): complex64, 3, 126 and 42;
- 16-atom spinor (full_width_spinor_us_fp32): complex64, 4, 252 and 84.

Each shape is timed (CUDA events, median of 21 samples of 5 calls) on a
seeded Hermitian matrix built like an overlap (V V^H over 2 m random
rows, normalized), through each route:

- native: torch.linalg.eigh on the working type, as the parent runs it;
- fp64: cast to float64 / complex128, eigh, cast the results back;
- magma: torch.backends.cuda.preferred_linalg_library("magma") around the
  call, restored after it;
- pad: the matrix padded to order 513 with a diagonal block above its
  Gershgorin bound, where PyTorch hands a float32 matrix to syevd rather
  than Jacobi, the leading block of the result kept.

For each route it lists the device kernels of one call (torch.profiler,
by device time) and the largest gap of its eigenvalues to the float64
solution. One JSON line a shape and route, then the card's name and power
limit. --float32-orders N,... times the native and pad routes of single
float32 matrices of those orders instead (where padding starts to pay).

    python3 tools/torch_port_eigh_routes.py [--out FILE]
        [--float32-orders 129,192,256,320,387,448,512]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = (("gamma54", "float32", 1, 387), ("gamma54", "float32", 1, 129),
          ("us16_polished", "complex64", 3, 126),
          ("us16_polished", "complex64", 3, 42),
          ("spinor16", "complex64", 4, 252), ("spinor16", "complex64", 4, 84))
WIDE = {"float32": "float64", "complex64": "complex128"}


def matrix(torch, dtype, batch: int, m: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    v = rng.standard_normal((batch, m, 2 * m))
    if dtype.is_complex:
        v = v + 1j * rng.standard_normal((batch, m, 2 * m))
    a = torch.as_tensor(v @ np.conj(np.swapaxes(v, 1, 2)) / (2 * m))
    return a.to(dtype).cuda()


def route_fn(torch, name: str, a):
    if name == "native":
        return lambda: torch.linalg.eigh(a)
    if name == "fp64":
        wide = getattr(torch, WIDE[str(a.dtype).split(".")[1]])

        def cast():
            e, v = torch.linalg.eigh(a.to(wide))
            return e.to(torch.float32), v.to(a.dtype)
        return cast

    if name == "pad":
        n = a.shape[-1]
        shift = 1.0 + a.abs().sum(-1).amax(-1)
        big = torch.zeros(a.shape[:-2] + (513, 513), dtype=a.dtype,
                          device=a.device)

        def pad():
            big[..., :n, :n] = a
            big[..., n:, n:] = torch.diag_embed(
                shift[..., None].expand(a.shape[:-2] + (513 - n,)))
            e, v = torch.linalg.eigh(big)
            return e[..., :n], v[..., :n, :n]
        return pad

    def magma():
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("magma")
        try:
            return torch.linalg.eigh(a)
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)
    return magma


def time_ms(torch, fn, samples: int = 21, inner: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return sorted(times)[samples // 2]


def kernels_of(torch, fn) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = [{"name": e.key[:120], "count": int(e.count),
            "device_ms": float(e.self_device_time_total) / 1e3}
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(out, key=lambda k: -k["device_ms"])[:8]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the lines here")
    ap.add_argument("--float32-orders", default="",
                    help="native against pad on float32 matrices of these "
                    "orders")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_eigh_routes: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    lines = []
    shapes, routes = SHAPES, ("native", "fp64", "magma", "pad")
    if args.float32_orders:
        shapes = [("order", "float32", 1, int(m))
                  for m in args.float32_orders.split(",")]
        routes = ("native", "pad")
    for i, (run, dtype_name, batch, m) in enumerate(shapes):
        a = matrix(torch, getattr(torch, dtype_name), batch, m, 100 + i)
        exact = torch.linalg.eigh(a.to(getattr(torch, WIDE[dtype_name])))[0]
        for name in routes:
            rec = {"run": run, "dtype": dtype_name, "batch": batch, "m": m,
                   "route": name, "gpu": torch.cuda.get_device_name(0),
                   "nvidia_smi": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda}
            try:
                fn = route_fn(torch, name, a)
                e = fn()[0]
                rec["ms"] = time_ms(torch, fn)
                rec["kernels"] = kernels_of(torch, fn)
                rec["max_eig_err"] = float((e.double() - exact.double()).abs().max())
            except RuntimeError as err:  # a route this build lacks (magma)
                rec["error"] = str(err)[:300]
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
