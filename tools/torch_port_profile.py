"""Where the time goes in one SCF iteration of the PyTorch port on the GPU.

Runs a full-width deck of chip_smoke.py for a few SCF iterations with
unreachable tolerances, profiles the last ones with torch.profiler (after
one warm-up iteration under the profiler, whose records are dropped), and
prints one JSON object: device time by kernel and by category (cuFFT,
cuBLAS GEMM, cuSOLVER eigh, the port's hand kernels, other torch
elementwise/reduction kernels, copies), the wall time of the profiled
iterations and the device's busy share of it. The decks:

- default: the 16-atom Si supercell (2x2x2 k-mesh, gk 6 / pw 20),
  norm-conserving without symmetry; --ultrasoft: the same cell with the
  ultrasoft species, its 384-op space group and the irreducible k-mesh;
  --scan: that ultrasoft cell with the SCAN meta-GGA, the k-set band solve
  with the tau operator (chip_smoke.py's full_width_scan_us);
- --gamma: the 54-atom Gamma-only supercell (ultrasoft, 1296-op space
  group) through the packed-real Gamma band solve; --chunked: the same
  deck through the chunked projectors, 16 atoms a chunk; --gamma-pbe-fm:
  the same cell spin-polarized with PBE and a starting moment of 0.5 on
  every atom (its magnetic space group), through the packed-real solve one
  spin at a time (chip_smoke.py's full_width_gamma_pbe_fm).

    python3 tools/torch_port_profile.py
        [--ultrasoft | --scan | --gamma | --chunked | --gamma-pbe-fm]
        [--iters 3] [--profiled 2] [--out FILE]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROFILER_RECORDS = ("Buffer Flush", "Activity Buffer Request",
                    "ProfilerStep*")
# K1's and K8a's zero fill is a cudaMemsetAsync: it counts under copies
HAND_KERNELS = ("scatter_valid", "gather_hpsi", "residual_rows",
                "accumulate", "lda_xc_points", "veff_multiply_kernel",
                "rho_aug_kernel", "d_operator_partial_kernel",
                "d_operator_finish_kernel", "symmetrize_pw_kernel",
                "unpack_scatter", "pack_gather", "beta_chunk_kernel",
                "gga_xc_polarized", "gga_xc_unpolarized", "gradient_scatter",
                "divergence_gather", "mgga_xc_polarized",
                "mgga_xc_unpolarized", "grad_scatter", "grad_gather")
# the band-solve entry point of each path, as dft/scf.py calls it
SOLVES = ("davidson_kset", "davidson_kset_mgga", "davidson_gamma", "davidson")


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
    deck = ap.add_mutually_exclusive_group()
    deck.add_argument("--ultrasoft", action="store_true",
                      help="the 16-atom ultrasoft + symmetry deck instead of "
                      "the norm-conserving one")
    deck.add_argument("--scan", action="store_true",
                      help="the 16-atom ultrasoft + symmetry deck with SCAN "
                      "(k-set band solve with the tau operator)")
    deck.add_argument("--gamma", action="store_true",
                      help="the 54-atom Gamma-only ultrasoft + symmetry deck "
                      "(packed-real band solve)")
    deck.add_argument("--chunked", action="store_true",
                      help="the 54-atom deck through the chunked projectors")
    deck.add_argument("--gamma-pbe-fm", action="store_true",
                      help="the 54-atom Gamma-only deck spin-polarized with "
                      "PBE (packed-real band solve per spin)")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from sirius_tpu_torch.dft import scf as scf_mod
    from sirius_tpu_torch.testing import synthetic_silicon_context

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    single_k = args.gamma or args.chunked or args.gamma_pbe_fm
    us = args.ultrasoft or args.scan or single_k
    run = {"num_dft_iter": args.iters, "density_tol": 0.0, "energy_tol": 0.0}
    if args.scan:
        run["xc_functionals"] = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
    if args.gamma_pbe_fm:
        import chip_smoke

        ctx = chip_smoke.magnetic_supercell_context(
            3, chip_smoke.GAMMA54,
            dict(run, xc_functionals=chip_smoke.PBE, **chip_smoke.SPIN),
            chip_smoke.US_SYM, 0.5)
    else:
        ctx = synthetic_silicon_context(
            gk_cutoff=6.0, pw_cutoff=20.0,
            ngridk=(1, 1, 1) if single_k else (2, 2, 2),
            supercell=3 if single_k else 2, ultrasoft=us, use_symmetry=us,
            extra_params=run)
    if args.chunked:
        ctx.cfg.control.beta_chunked = True
        ctx.cfg.control.beta_chunk_size = 16
    deck_name = ("si54_supercell3_chunk16" if args.chunked
                 else "si54_supercell3_gamma_pbe_fm" if args.gamma_pbe_fm
                 else "si54_supercell3_gamma" if args.gamma
                 else "si16_supercell2_us_sym_scan" if args.scan
                 else "si16_supercell2_us_sym" if args.ultrasoft
                 else "si16_supercell2")
    first = args.iters - args.profiled
    if first < 1:
        print("torch_port_profile: --iters must exceed --profiled (one "
              "iteration warms the profiler up)", file=sys.stderr)
        return 2
    # the profiler opens one iteration early: that iteration is its
    # warm-up (CUPTI starts up there; its records are dropped), the
    # `profiled` iterations after it are recorded
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=args.profiled,
                                     repeat=1),
                   acc_events=True)
    state = {"fermi": 0, "it": None, "solves": 0}
    # find_fermi runs once per SCF iteration, after the band solve(s) and
    # the retry if any, so the first band solve after n find_fermi calls
    # starts iteration n
    orig = {name: getattr(scf_mod, name) for name in SOLVES + ("find_fermi",)}

    def hooked(name):
        def solve(*a, **kw):
            it = state["fermi"]
            if state["it"] is None and it == first - 1:
                torch.cuda.synchronize()
                prof.__enter__()
                state["it"] = it
            elif state["it"] is not None and it != state["it"]:
                torch.cuda.synchronize()
                prof.step()
                state["it"] = it
            if state["it"] is not None and it >= first:
                state["solves"] += 1
            return orig[name](*a, **kw)
        return solve

    def hooked_fermi(*a, **kw):
        state["fermi"] += 1
        return orig["find_fermi"](*a, **kw)

    for name in SOLVES:
        setattr(scf_mod, name, hooked(name))
    scf_mod.find_fermi = hooked_fermi
    try:
        res = scf_mod.run_scf(ctx.cfg, ctx=ctx, device=dev)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        for name, fn in orig.items():
            setattr(scf_mod, name, fn)
    profiled = list(range(first, res["num_scf_iterations"]))
    # the profiled iterations' own host-clock times (each starts after a
    # synchronize): the end-of-run report after the loop is not in them
    wall = sum(res["iteration_seconds"][first:])

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
        "deck": deck_name,
        # 0-based SCF iterations inside the profiler, and the band solves
        # they made (one each unless a residual-health retry ran)
        "profiled_iterations": profiled, "profiled_band_solves": state["solves"],
        "wall_s": wall, "wall_s_per_iteration": wall / len(profiled),
        "device_busy_ms": busy,
        "device_busy_share": busy / (wall * 1e3),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": kernels[:25],
        "iteration_seconds": res["iteration_seconds"],
        "band_solve_seconds": res["band_solve_seconds"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
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
