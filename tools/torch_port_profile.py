"""Where the time goes in one SCF iteration of the PyTorch port on the GPU.

Runs the 16-atom Si supercell deck of chip_smoke.py (2x2x2 k-mesh, gk 6 /
pw 20; norm-conserving without symmetry, or with --ultrasoft the ultrasoft
species with the 384-op space group and the irreducible k-mesh) for a few
SCF iterations with unreachable tolerances, profiles the last ones with
torch.profiler, and prints one JSON object: device time by kernel and by
category (cuFFT, cuBLAS GEMM, cuSOLVER eigh, the port's hand kernels, other
torch elementwise/reduction kernels, copies), the wall time of the profiled
iterations and the device's busy share of it.

    python3 tools/torch_port_profile.py [--ultrasoft] [--iters 3]
        [--profiled 2] [--out FILE]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROFILER_RECORDS = ("Buffer Flush", "Activity Buffer Request")
HAND_KERNELS = ("zero_fill", "scatter_valid", "gather_hpsi", "residual_rows",
                "accumulate", "lda_xc_points", "veff_multiply_kernel",
                "rho_aug_kernel", "d_operator_partial_kernel",
                "d_operator_finish_kernel", "symmetrize_pw_kernel")


def category(name: str) -> str:
    n = name.lower()
    if any(k in name for k in HAND_KERNELS) and "at::" not in name:
        return "hand kernels"
    if "fft" in n:
        return "cufft"
    if any(k in n for k in ("syevd", "heevd", "syevj", "heevj", "stedc", "sytrd",
                            "hetrd", "ormtr", "unmtr", "larf", "steqr", "lacpy",
                            "cusolver", "sterf", "geqrf", "latrd")):
        return "cusolver eigh"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere_z",
                            "zgemm", "trsm", "herk", "syrk", "dot_kernel")):
        return "cublas"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "torch elementwise/reduction"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3,
                    help="SCF iterations in all (the first is not profiled)")
    ap.add_argument("--profiled", type=int, default=2,
                    help="trailing iterations inside the profiler")
    ap.add_argument("--ultrasoft", action="store_true",
                    help="the ultrasoft + symmetry deck instead of the "
                    "norm-conserving one")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sirius_tpu_torch.dft import scf as scf_mod
    from sirius_tpu_torch.testing import synthetic_silicon_context

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ctx = synthetic_silicon_context(
        gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2), supercell=2,
        ultrasoft=args.ultrasoft, use_symmetry=args.ultrasoft,
        extra_params={"num_dft_iter": args.iters, "density_tol": 0.0,
                      "energy_tol": 0.0})
    first = args.iters - args.profiled
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    state = {"fermi": 0, "t0": None, "solves": 0}
    # open the profiler at the start of iteration `first`: find_fermi runs
    # once per SCF iteration, after the band solve and its retry if any, so
    # the first band solve after `first` find_fermi calls starts it
    orig_solve, orig_fermi = scf_mod.davidson_kset, scf_mod.find_fermi

    def hooked_solve(*a, **kw):
        if state["t0"] is None and state["fermi"] == first:
            torch.cuda.synchronize()
            prof.__enter__()
            state["t0"] = time.perf_counter()
        if state["t0"] is not None:
            state["solves"] += 1
        return orig_solve(*a, **kw)

    def hooked_fermi(*a, **kw):
        state["fermi"] += 1
        return orig_fermi(*a, **kw)

    scf_mod.davidson_kset, scf_mod.find_fermi = hooked_solve, hooked_fermi
    try:
        res = scf_mod.run_scf(ctx.cfg, ctx=ctx, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t0"]
        prof.__exit__(None, None, None)
    finally:
        scf_mod.davidson_kset, scf_mod.find_fermi = orig_solve, orig_fermi
    profiled = list(range(first, res["num_scf_iterations"]))

    kernels = []
    for e in prof.key_averages():
        # device-side kernel records only: the CPU-side aten ops repeat
        # their kernels' time, and the profiler's own buffer records are
        # not work of the program
        if e.device_type != DeviceType.CUDA or e.key in PROFILER_RECORDS:
            continue
        t = float(e.self_device_time_total)
        if t > 0:
            kernels.append({"name": e.key[:160], "count": int(e.count),
                            "device_ms": t / 1e3, "category": category(e.key)})
    kernels.sort(key=lambda k: -k["device_ms"])
    by_cat: dict[str, float] = {}
    for k in kernels:
        by_cat[k["category"]] = by_cat.get(k["category"], 0.0) + k["device_ms"]
    busy = sum(by_cat.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "tool": "tools/torch_port_profile.py",
        "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "deck": ("si16_supercell2_us_sym" if args.ultrasoft
                 else "si16_supercell2"),
        # 0-based SCF iterations inside the profiler, and the band solves
        # they made (one each unless a residual-health retry ran)
        "profiled_iterations": profiled, "profiled_band_solves": state["solves"],
        "wall_s": wall, "wall_s_per_iteration": wall / len(profiled),
        "device_busy_ms": busy,
        "device_busy_share": busy / (wall * 1e3),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": kernels[:25],
        "iteration_seconds": res["iteration_seconds"],
    }
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
