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
  spin at a time (chip_smoke.py's full_width_gamma_pbe_fm);
- --spinor: the 16-atom ultrasoft cell non-collinear (num_mag_dims 3) with
  a starting moment of (0.3, 0.3, 0.3) on every atom, its 48-op magnetic
  space group and 4 k-points, through the spinor k-set solve
  (chip_smoke.py's full_width_spinor_us);
- --fp32 with any of them: the same deck with precision_wf "fp32" (the band
  solve in complex64 / float32, chip_smoke.py's *_fp32 runs, without the
  polish);
- --device-scf off with a k-set deck: the host loop in place of the fused
  step (control.device_scf; the default "auto" fuses where dft/scf.py::
  fuses says).

It also counts the host syncs of the profiled iterations (PyTorch's
set_sync_debug_mode("warn"), explicit synchronizes included) and prints
them an iteration (syncs_per_iteration), the host's launches an iteration
(launches_per_iteration: kernels, memsets and copies put on the device),
and the launches of the window's potential generations
(potential_launches: each generate_potential call is a profiler range;
its launch calls, and the device operations they started by name).

The device's idle time (the profiled window less the union of its kernel,
copy and memset intervals in the exported trace) is split by what the host
was doing meanwhile: inside a CUDA synchronize or blocking copy (waiting on
the device's tail), launching work, in the allocator, or none of these
(Python, numpy and other host code: the host's own share).

    python3 tools/torch_port_profile.py
        [--ultrasoft | --scan | --gamma | --chunked | --gamma-pbe-fm
         | --spinor] [--fp32] [--device-scf auto|off] [--iters 3]
        [--profiled 2] [--out FILE]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROFILER_RECORDS = ("Buffer Flush", "Activity Buffer Request",
                    "ProfilerStep*")
# K1's and K8a's zero fill is a cudaMemsetAsync: it counts under copies
HAND_KERNELS = ("scatter_valid", "gather_hpsi", "residual_rows",
                "accumulate", "lda_xc_points", "veff_multiply_kernel",
                "rho_aug_kernel", "d_operator_partial_kernel",
                "d_operator_finish_kernel", "symmetrize_pw_kernel",
                "unpack_scatter", "pack_pairs", "beta_chunk_kernel",
                "gga_xc_polarized", "gga_xc_unpolarized", "gradient_scatter",
                "divergence_gather", "mgga_xc_polarized",
                "mgga_xc_unpolarized", "grad_scatter", "grad_gather",
                "spinor_veff_kernel", "symmetrize_vector_kernel",
                "coarse_box_kernel", "scatter_fine_kernel", "h_diag_kernel",
                "xc_inputs_kernel", "xc_outputs_kernel",
                "hartree_veff_kernel", "gga_inputs_kernel",
                "coarse_fill_kernel", "coarse_stack_kernel")
# the band-solve entry point of each path, as dft/scf.py (and, for the
# spinor path, dft/scf_nc.py) calls it
SOLVES = ("davidson_kset", "davidson_kset_mgga", "davidson_gamma", "davidson")
SOLVES_NC = ("davidson_kset_nc",)
# trace categories of device work, and how the host's CUDA runtime calls
# classify the idle time they overlap
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def runtime_kind(name: str) -> str:
    """The idle-time class of a host CUDA runtime or driver call."""
    if "Synchronize" in name or name in ("cudaMemcpy", "cuMemcpyDtoH_v2"):
        return "sync_wait"
    if "Malloc" in name or "Free" in name or "HostAlloc" in name:
        return "allocator"
    return "launch"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(gaps, intervals) -> float:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(gaps) and j < len(intervals):
        a = max(gaps[i][0], intervals[j][0])
        b = min(gaps[i][1], intervals[j][1])
        if b > a:
            total += b - a
        if gaps[i][1] < intervals[j][1]:
            i += 1
        else:
            j += 1
    return total


def _subtract(gaps, intervals):
    """The parts of sorted disjoint gaps outside sorted disjoint intervals,
    in one pass over both lists."""
    rest = []
    j = 0
    for a, b in gaps:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(intervals) and intervals[k][0] < b:
            c, d = intervals[k]
            if c > cur:
                rest.append([cur, c])
            cur = max(cur, d)
            k += 1
        if cur < b:
            rest.append([cur, b])
    return rest


def idle_breakdown(events) -> dict:
    """Split the device's idle time over a trace window (Chrome trace
    events: dicts with cat, name, ts and dur in microseconds) by the host's
    activity. The window runs from the first to the last device interval.
    Returns milliseconds: window, busy, idle, and idle spent while the host
    waits in a synchronize (sync_wait), launches work (launch), is in the
    allocator (allocator) or runs none of these (host: Python, numpy and
    other host code). Host classes are assigned in that order, so a
    nested call counts once."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("dur", 0.0) > 0]
    if not dev:
        return {"window_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0,
                "sync_wait_ms": 0.0, "launch_ms": 0.0, "allocator_ms": 0.0,
                "host_ms": 0.0}
    busy = _union(dev)
    lo, hi = busy[0][0], busy[-1][1]
    gaps = [[a[1], b[0]] for a, b in zip(busy, busy[1:])]
    idle = sum(b - a for a, b in gaps)
    out = {"window_ms": (hi - lo) / 1e3,
           "busy_ms": sum(b - a for a, b in busy) / 1e3,
           "idle_ms": idle / 1e3}
    left = gaps
    for kind in ("sync_wait", "launch", "allocator"):
        calls = _union([(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and runtime_kind(e.get("name", "")) == kind])
        out[kind + "_ms"] = _overlap(left, calls) / 1e3
        # what stays idle outside these calls
        left = _subtract(left, calls)
    out["host_ms"] = sum(b - a for a, b in left) / 1e3
    return out


# host calls that put one piece of work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")
# the range the run's potential generations are annotated with
POTENTIAL_RANGE = "generate_potential"


def range_launches(events, range_name: str) -> dict:
    """The device work launched inside host ranges named range_name
    (Chrome trace events, as idle_breakdown): the ranges' count, the host
    launch calls inside them (LAUNCH_CALLS), and the device operations
    they started (kernels, memsets, copies, matched by correlation id) by
    name."""
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
              if e.get("name") == range_name
              and e.get("cat") in ("user_annotation", "cpu_op")]
    inside = [e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and e.get("name", "").startswith(LAUNCH_CALLS)
              and any(a <= e["ts"] < b for a, b in ranges)]
    corr = {e.get("args", {}).get("correlation") for e in inside}
    names: dict[str, int] = {}
    for e in events:
        if (e.get("cat") in DEVICE_CATS
                and e.get("args", {}).get("correlation") in corr):
            key = e.get("name", "")[:120]
            names[key] = names.get(key, 0) + 1
    return {"ranges": len(ranges), "launch_calls": len(inside),
            "device_ops": sum(names.values()),
            "device_ops_by_name": dict(sorted(names.items(),
                                              key=lambda kv: -kv[1]))}


def category(name: str) -> str:
    n = name.lower()
    if any(k in name for k in HAND_KERNELS) and "at::" not in name:
        return "hand kernels"
    if "fft" in n:
        return "cufft"
    # (syevbj / *_rotate_batch: the Jacobi kernels cuSOLVER runs for the
    # float32 Rayleigh-Ritz of the fp32 Gamma path)
    if any(k in n for k in ("syevd", "heevd", "syevj", "heevj", "syevbj",
                            "heevbj", "rotate_batch", "stedc", "sytrd",
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
    deck.add_argument("--spinor", action="store_true",
                      help="the 16-atom ultrasoft deck non-collinear with "
                      "(0.3, 0.3, 0.3) on every atom (spinor k-set solve)")
    ap.add_argument("--fp32", action="store_true",
                    help="the deck with precision_wf fp32")
    ap.add_argument("--device-scf", choices=("auto", "off"), default="auto",
                    help="control.device_scf: the fused step where the "
                    "deck fuses (auto), or the host loop (off)")
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
    from sirius_tpu_torch.dft import scf_nc as scf_nc_mod
    from sirius_tpu_torch.testing import synthetic_silicon_context

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    single_k = args.gamma or args.chunked or args.gamma_pbe_fm
    us = args.ultrasoft or args.scan or single_k
    run = {"num_dft_iter": args.iters, "density_tol": 0.0, "energy_tol": 0.0}
    if args.scan:
        run["xc_functionals"] = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
    if args.spinor:
        import chip_smoke

        ctx = chip_smoke.magnetic_supercell_context(
            2, chip_smoke.FULL, dict(run, **chip_smoke.NONCOLLINEAR),
            chip_smoke.US_SYM, chip_smoke.CANTED[0])
    elif args.gamma_pbe_fm:
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
    if args.fp32:
        ctx.cfg.parameters.precision_wf = "fp32"
    ctx.cfg.control.device_scf = args.device_scf
    deck_name = ("si16_supercell2_us_sym_spinor" if args.spinor
                 else "si54_supercell3_chunk16" if args.chunked
                 else "si54_supercell3_gamma_pbe_fm" if args.gamma_pbe_fm
                 else "si54_supercell3_gamma" if args.gamma
                 else "si16_supercell2_us_sym_scan" if args.scan
                 else "si16_supercell2_us_sym" if args.ultrasoft
                 else "si16_supercell2") + ("_fp32" if args.fp32 else "")
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
    state = {"fermi": 0, "it": None, "solves": 0, "starts": {}}
    caught: list = []
    # find_fermi runs once per SCF iteration, after the band solve(s) and
    # the retry if any, so the first band solve after n find_fermi calls
    # starts iteration n
    # the module whose band solves and Fermi search the run calls
    mod = scf_nc_mod if args.spinor else scf_mod
    solves = SOLVES_NC if args.spinor else SOLVES
    orig = {name: getattr(mod, name) for name in solves + ("find_fermi",)}

    def hooked(name):
        def solve(*a, **kw):
            it = state["fermi"]
            # the position of the iteration's first band solve among the
            # warnings (the syncs of one iteration are counted from it)
            state["starts"].setdefault(it, len(caught))
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

    # every potential generation of the run as a host range: the
    # launches it makes are counted from the trace (potential_launches)
    from sirius_tpu_torch.dft import fused as fused_mod

    orig_pot = {m: m.generate_potential for m in (scf_mod, fused_mod)}

    def annotated(fn):
        def generate_potential(*a, **kw):
            with torch.profiler.record_function(POTENTIAL_RANGE):
                return fn(*a, **kw)
        return generate_potential

    for name in solves:
        setattr(mod, name, hooked(name))
    mod.find_fermi = hooked_fermi
    for m, fn in orig_pot.items():
        m.generate_potential = annotated(fn)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            res = scf_mod.run_scf(ctx.cfg, ctx=ctx, device=dev)
            torch.cuda.set_sync_debug_mode(0)
            # the syncs of the first profiled iteration, from its band solve
            # to the next iteration's
            a, b = state["starts"][first], state["starts"][first + 1]
            syncs = [w for w in caught[a:b] if "synchroniz" in str(w.message)]
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for name, fn in orig.items():
            setattr(mod, name, fn)
        for m, fn in orig_pot.items():
            m.generate_potential = fn
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = (trace.get("traceEvents", trace) if isinstance(trace, dict)
              else trace)
    idle = idle_breakdown(events)
    launches = range_launches(events, POTENTIAL_RANGE)
    # every host launch of the window, an iteration
    window_launches = sum(
        1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and e.get("name", "").startswith(LAUNCH_CALLS))
    del trace, events
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "tool": "tools/torch_port_profile.py",
        "gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "deck": deck_name, "device_scf": res.get("device_scf", False),
        # 0-based SCF iterations inside the profiler, and the band solves
        # they made (one each unless a residual-health retry ran)
        "profiled_iterations": profiled, "profiled_band_solves": state["solves"],
        "wall_s": wall, "wall_s_per_iteration": wall / len(profiled),
        "device_busy_ms": busy,
        # host syncs of one iteration (the first profiled one)
        "syncs_per_iteration": len(syncs),
        "device_busy_share": busy / (wall * 1e3),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        # the device's idle time in the traced window by the host's
        # activity; host_ms is the host's own share (Python, numpy)
        "idle_breakdown_ms": idle,
        # host launches an iteration, and those of the potential
        # generations in the window (each one's device work by name)
        "launches_per_iteration": window_launches / len(profiled),
        "potential_launches": launches,
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
