"""K8b's and K9's time on the card at the 54-atom full-width shapes.

For K8b (kernels/gamma_pack.py::box_to_packed_hx: 1 x 258 rows of 26,469
packed slots, box 90^3, float64 and float32) and K9 (kernels/beta_chunk.py::
beta_chunk: 16 atoms x 4 projectors, ngk 26,469, complex128 and complex64,
a full chunk step and the last one, padded), on the tables of the 54-atom
Gamma cell of chip_smoke.py and seeded blocks, prints one JSON line a
(kernel, type, case): the event time of back-to-back calls, the device time
of the kernel (torch.profiler), the host time to enqueue one call, the
bytes of the row's bound and that bound, and, for K8b, its launch plan
(kernels/gamma_pack.py::pack_plan), whether it is bitwise its plain
version, and the 32-byte sectors of the box that each warp's gathers touch
under each pair order (counted from the tables on the host; the bound's
box bytes beside them). Where
`ncu` is on the machine it also reads dram__bytes_read.sum and
dram__bytes_write.sum of one launch; where it is not, or refuses to run,
the line says so.

    python3 tools/torch_port_gather_plans.py [--kernels k8b k9] [--no-ncu]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 258  # the packed [X; P] block of the 54-atom band solve, 2 nb
CHUNK = 16
K8B_DEVICE = ("pack_pairs",)
K9_DEVICE = ("beta_chunk",)
NCU_METRICS = "dram__bytes_read.sum,dram__bytes_write.sum"


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def host_us(fn, calls: int = 20) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def warp_sectors(addr, element_bytes: int, warp: int = 32) -> int:
    """32-byte sectors touched by warps of `warp` consecutive threads, the
    thread i reading one element_bytes entry at addr[i] (elements)."""
    import numpy as np

    sec = np.asarray(addr, dtype=np.int64) * element_bytes // 32
    n = -(-len(sec) // warp) * warp
    pad = np.full(n, -1, dtype=np.int64)
    pad[:len(sec)] = sec
    rows = np.sort(pad.reshape(-1, warp), axis=1)
    distinct = (rows[:, 1:] != rows[:, :-1]) & (rows[:, 1:] >= 0)
    return int(distinct.sum() + (rows[:, 0] >= 0).sum())


def k8b_sectors(rep_box, par_box, cb: int) -> dict:
    """Box sectors a row's gathers touch: one thread a packed slot, each Re
    and each Im slot reading both members (a gather per slot), and one
    thread a pair, each member read once, in sphere order (pack_pairs) and
    in box order of the representative."""
    import numpy as np

    rep, par = np.asarray(rep_box), np.asarray(par_box)
    natural = warp_sectors(rep, cb) + warp_sectors(par, cb)
    order = np.argsort(rep, kind="stable")
    return {"per_slot": 2 * natural, "per_pair_sphere_order": natural,
            "per_pair_box_order": (warp_sectors(rep[order], cb)
                                   + warp_sectors(par[order], cb)),
            "bound": -(-2 * len(rep) * cb // 32)}


def ncu_bytes(kernel: str, dtype: str) -> dict:
    """dram bytes of one launch under ncu, or why there are none."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(ncu):
        return {"ncu": "not on this machine"}
    cmd = [ncu, "--metrics", NCU_METRICS, "--csv", "--launch-count", "1",
           "--kernel-name", "regex:" + ("pack" if kernel == "k8b" else
                                        "beta_chunk"),
           sys.executable, os.path.abspath(__file__), "--one", kernel, dtype]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        return {"ncu": "timed out"}
    vals = {}
    for line in out.stdout.splitlines():
        for m in NCU_METRICS.split(","):
            if f'"{m}"' in line:
                vals[m] = line.rsplit(",", 1)[-1].strip('"')
    if not vals:
        tail = (out.stderr or out.stdout).strip().splitlines()[-3:]
        return {"ncu": f"no metrics (rc {out.returncode})", "ncu_tail": tail}
    return {"ncu": vals}


def setup(dev):
    """The 54-atom Gamma cell's context (as chip_smoke.py builds it)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    return cs, cs.make_context(cs.GAMMA54, {"num_dft_iter": 1,
                                            **cs.RUN_TO_END}, cs.US_SYM)


def k8b_cases(cs, ctx, dev, dtype: str):
    """(name, fn, fields) of K8b at this type."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import gamma_pack as k8
    from sirius_tpu_torch.ops.gamma import build_gamma_map, make_gamma_params

    real = getattr(torch, dtype)
    cb, rb = (8, 4) if real == torch.float32 else (16, 8)
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    ngk = ctx.gkvec.ngk_max
    gm = build_gamma_map(np.asarray(ctx.gkvec.millers[0]),
                         np.asarray(ctx.gkvec.mask[0]))
    gp = make_gamma_params(ctx, np.zeros(dims), gm, device=dev, dtype=real)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((1, ROWS, ngk)),
                        device=dev).to(real)
    z = torch.as_tensor(rng.standard_normal((2, 1, ROWS, n)), device=dev)
    vbox = torch.complex(z[0], z[1]).to(
        torch.complex64 if real == torch.float32 else torch.complex128)
    del z
    npair = int(gp.rep_box.shape[0])
    nbytes = (ROWS * (2 * npair + 1) * cb + ROWS * ngk * 3 * rb
              + ngk * 2 * rb + npair * 8)
    fields = {"rows": ROWS, "ngk": ngk, "npair": npair, "nbox": n,
              "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
              "sectors_per_row": k8b_sectors(gp.rep_box.cpu().numpy(),
                                             gp.par_box.cpu().numpy(), cb)}
    args = (vbox, x, gp.ekin_p, gp.mask_p, gp.rep_box, gp.par_box,
            gp.zero_box)
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(k8.box_to_packed_hx(*args), k8.box_to_packed_hx_plain(*args)))
    yield "pairs", (lambda: k8.box_to_packed_hx(*args)), {
        **fields, "plan": k8.pack_plan(ROWS, ngk, npair), "bitwise": same}


def k9_cases(cs, ctx, dev, dtype: str):
    """(name, fn, fields) of K9 at this type, on the first and the last
    (padded) chunk step."""
    import torch

    from sirius_tpu_torch.ops.beta_chunked import make_chunked_hk

    cplx = getattr(torch, dtype)
    cb, rb = (8, 4) if cplx == torch.complex64 else (16, 8)
    prm = make_chunked_hk(ctx, 0, chunk=CHUNK, device=dev, dtype=cplx)
    c, nxi = prm.xi_rf.shape[1:]
    ngk, lmmax = prm.rlm.shape
    nrf = prm.ri_grid.shape[0]
    nbytes = c * nxi * ngk * cb + ngk * rb * (4 + lmmax + nrf) + ngk * 3 * rb
    for step in (0, prm.num_steps - 1):
        fields = {"step": step, "atoms": c, "nxi": nxi, "ngk": ngk,
                  "real_atoms": int((prm.cph[step].abs().sum(1) > 0).sum()),
                  "bytes": nbytes,
                  "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        yield "default", (lambda s=step: prm.beta(s)), fields


def one(kernel: str, dtype: str) -> int:
    """Launch one kernel a few times (the process ncu profiles)."""
    import torch

    dev = torch.device("cuda")
    cs, ctx = setup(dev)
    cases = (k8b_cases if kernel == "k8b" else k9_cases)(cs, ctx, dev, dtype)
    _, fn, _ = next(iter(cases))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=["k8b", "k9"],
                    choices=["k8b", "k9"])
    ap.add_argument("--no-ncu", action="store_true")
    ap.add_argument("--one", nargs=2, metavar=("KERNEL", "TYPE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_gather_plans: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.kernels import build

    build.build_all(("gamma_pack", "beta_chunk"))
    if args.one:
        return one(*args.one)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = smi()
    cs, ctx = setup(dev)
    for kernel in args.kernels:
        types = (("float64", "float32") if kernel == "k8b"
                 else ("complex128", "complex64"))
        cases, names = ((k8b_cases, K8B_DEVICE) if kernel == "k8b"
                        else (k9_cases, K9_DEVICE))
        for dtype in types:
            first = True
            for name, fn, fields in cases(cs, ctx, dev, dtype):
                rec = {"kernel": kernel, "dtype": dtype, "case": name,
                       "ms": cs.time_ms(fn),
                       "device_ms": cs.device_ms(fn, dev, names),
                       "host_us_per_call": host_us(fn), **fields,
                       "nvidia_smi": gpu}
                if first and not args.no_ncu:
                    rec.update(ncu_bytes(kernel, dtype))
                    first = False
                print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
