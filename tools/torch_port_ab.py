"""Seconds per SCF iteration of two checkouts of the port, on one card.

Runs chip_smoke.py's full-width runs (full_width_us and its fp32 twin
polished as chip_smoke.py polishes it, full_width_gamma_us and its fp32
twin, full_width_chunked_us, full_width_gamma_pbe_fm, full_width_scan_us,
full_width_spinor_us and its fp32 twin; --runs names a subset, by the
first of each group: us, gamma, chunked, gamma_pbe_fm, scan, spinor) from
this checkout (A) and from another one (B),
each in its own process, in the order A B B A, and prints one JSON line a
run: the checkout, each phase's iteration seconds and peak device memory.
Two versions are compared only inside one call: a card's speed moves
between calls.

With --parity it then runs chip_smoke.py's 2-atom parity decks once from
each checkout (A, then B), with their gates, and prints each run's energy,
energy-term gap to the record and iteration count a deck, and a last line
saying whether the two checkouts gave the same numbers bit for bit (a
gate that fails is reported, not raised).

    python3 tools/torch_port_ab.py --other DIR [--order ABBA] [--parity]
        [--runs us,gamma,chunked,gamma_pbe_fm,scan,spinor]

DIR is a checkout of another commit (for instance `git archive` of the
parent unpacked into a git-ignored directory). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the child: the full-width runs of the chip_smoke.py found in its cwd
CHILD = r'''
import contextlib, io, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from sirius_tpu_torch.kernels import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
build.build_all()
gpu = torch.cuda.get_device_name(0)
with open(os.path.join("sirius_tpu_torch", "data", "jax_reference.json")) as f:
    refs = json.load(f)["decks"]
out = {}

def run(phase, ctx, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cs.full_width(ctx, dev, gpu, phase=phase, **kw)
    rec = [json.loads(l) for l in buf.getvalue().splitlines()
           if l.startswith("{") and '"phase": "%s"' % phase in l][-1]
    out[phase] = {"iteration_seconds": rec["iteration_seconds"],
                  "wf_precision": rec["wf_precision"],
                  "max_memory_allocated": rec["max_memory_allocated"]}
    torch.cuda.empty_cache()
    return res

RUNS = sys.argv[1].split(",")
if "us" in RUNS:
    ctx = cs.make_context(cs.FULL, {"num_dft_iter": cs.FULL_ITERS["full_width_us"],
                                    **cs.RUN_TO_END}, cs.US_SYM)
    _, res = run("full_width_us", ctx, required=cs.US_KERNELS,
                 with_result=True)
    rms = res["rms_history"]
    ctx.cfg.parameters.precision_wf = "fp32"
    ctx.cfg.settings.fp32_to_fp64_rms = cs.polish_threshold(rms)
    run("full_width_us_fp32", ctx, required=cs.FP32_US_KERNELS,
        deck="si16_supercell2_us_sym",
        electron_tol=cs.fp32_electron_tol(refs, ctx.unit_cell.num_valence_electrons))
    del ctx
if "gamma" in RUNS or "chunked" in RUNS:
    ctx = cs.make_context(cs.GAMMA54, {"num_dft_iter": cs.FULL_ITERS[
        "full_width_gamma_us"], **cs.RUN_TO_END}, cs.US_SYM)
    if "gamma" in RUNS:
        run("full_width_gamma_us", ctx, required=cs.GAMMA_US_KERNELS,
            deck="si54_supercell3_gamma", path="gamma")
        ctx.cfg.parameters.precision_wf = "fp32"
        run("full_width_gamma_us_fp32", ctx, required=cs.FP32_GAMMA_US_KERNELS,
            deck="si54_supercell3_gamma", path="gamma",
            electron_tol=cs.fp32_electron_tol(refs, ctx.unit_cell.num_valence_electrons))
        ctx.cfg.parameters.precision_wf = "fp64"
    if "chunked" in RUNS:
        ctx.cfg.control.beta_chunked = True
        ctx.cfg.control.beta_chunk_size = cs.CHUNK54
        run("full_width_chunked_us", ctx, required=cs.CHUNKED_US_KERNELS,
            deck="si54_supercell3_gamma", path="chunked")
    del ctx
if "gamma_pbe_fm" in RUNS:
    ctx = cs.magnetic_supercell_context(
        3, cs.GAMMA54, {"num_dft_iter": cs.FULL_ITERS["full_width_gamma_pbe_fm"],
                        **cs.RUN_TO_END, "xc_functionals": cs.PBE, **cs.SPIN},
        cs.US_SYM, 0.5)
    run("full_width_gamma_pbe_fm", ctx, required=cs.FULL_GAMMA_PBE_FM_KERNELS,
        deck="si54_supercell3_gamma_fm", path="gamma")
    del ctx
if "scan" in RUNS:
    ctx = cs.make_context(cs.FULL, {
        "num_dft_iter": cs.FULL_ITERS["full_width_scan_us"], **cs.RUN_TO_END,
        "xc_functionals": cs.SCAN}, cs.US_SYM)
    run("full_width_scan_us", ctx, required=cs.FULL_SCAN_KERNELS,
        deck="si16_supercell2_us_sym_scan")
    del ctx
if "spinor" in RUNS:
    ctx = cs.magnetic_supercell_context(
        2, cs.FULL, {"num_dft_iter": cs.FULL_ITERS["full_width_spinor_us"],
                     **cs.RUN_TO_END, **cs.NONCOLLINEAR}, cs.US_SYM, cs.CANTED[0])
    run("full_width_spinor_us", ctx, required=cs.SPINOR_SYM_KERNELS,
        deck="si16_supercell2_us_sym_spinor", path="kset_nc")
    ctx.cfg.parameters.precision_wf = "fp32"
    run("full_width_spinor_us_fp32", ctx, required=cs.FP32_SPINOR_SYM_KERNELS,
        deck="si16_supercell2_us_sym_spinor", path="kset_nc",
        electron_tol=cs.fp32_electron_tol(refs, ctx.unit_cell.num_valence_electrons))
print(json.dumps({"gpu": gpu, "runs": out}))
'''

# the child of --parity: the 2-atom parity decks of the chip_smoke.py found
# in its cwd, each deck's record lines (the gates' failures as text)
PARITY_CHILD = r'''
import contextlib, io, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from sirius_tpu_torch.kernels import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
build.build_all()
gpu = torch.cuda.get_device_name(0)
with open(os.path.join("sirius_tpu_torch", "data", "jax_reference.json")) as f:
    refs = json.load(f)["decks"]
tool = cs.reference_tool()
decks = {
    "full_width_2atom": lambda: cs.parity_scf(
        cs.make_context(cs.PARITY, cs.TIGHT), dev, refs["full_width_2atom"],
        gpu),
    "full_width_2atom_us_sym": lambda: cs.parity_scf(
        cs.make_context(cs.PARITY, cs.TIGHT, cs.US_SYM), dev,
        refs["full_width_2atom_us_sym"], gpu, phase="parity_scf_us",
        deck="full_width_2atom_us_sym", required=cs.US_KERNELS)}
for name in cs.SINGLE_K:
    path, req = cs.SINGLE_K_PATH[name]
    decks[name] = lambda name=name, path=path, req=req: cs.parity_scf(
        cs.single_k_context(name), dev, refs[name], gpu, deck=name,
        required=req, path=path)
for name in cs.XC_DECKS:
    path, req = cs.XC_DECK_PATH[name]
    decks[name] = lambda name=name, path=path, req=req: cs.parity_scf(
        cs.xc_context(name), dev, refs[name], gpu, deck=name, required=req,
        path=path)
for name in tool.SPINOR_DECKS:
    decks[name] = lambda name=name: cs.parity_scf(
        cs.deck_context(name, tool), dev, refs[name], gpu, deck=name,
        required=cs.SPINOR_DECK_PATH[name], path="kset_nc")
for name in cs.FP32_DECK_PATH:
    decks[name] = lambda name=name: cs.parity_scf_fp32(
        cs.deck_context(name, tool), dev, refs, name, gpu)
out = {}
keys = ("e_total", "d_total", "max_term_err", "num_scf_iterations",
        "max_moment_err")
for name, fn in decks.items():
    buf = io.StringIO()
    err = None
    with contextlib.redirect_stdout(buf):
        try:
            fn()
        except AssertionError as e:
            err = str(e)
    recs = [json.loads(l) for l in buf.getvalue().splitlines()
            if l.startswith("{")]
    out[name] = {k: r[k] for r in recs for k in keys if k in r}
    out[name]["gate_failed"] = err
    torch.cuda.empty_cache()
print(json.dumps({"gpu": gpu, "decks": out}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root (B)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--runs", default="us,gamma,chunked,gamma_pbe_fm,scan,"
                    "spinor", help="the full-width groups to run")
    ap.add_argument("--parity", action="store_true",
                    help="then the 2-atom parity decks, A then B")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ab: CUDA is not available", file=sys.stderr)
        return 2
    trees = {"A": ROOT, "B": os.path.abspath(args.other)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    runs = [(CHILD, which) for which in args.order if args.runs]
    if args.parity:
        runs += [(PARITY_CHILD, "A"), (PARITY_CHILD, "B")]
    parity = {}
    for i, (child, which) in enumerate(runs):
        proc = subprocess.run([sys.executable, "-c", child, args.runs],
                              cwd=trees[which], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if child is PARITY_CHILD:
            parity[which] = rec["decks"]
        print(json.dumps({"run": i, "checkout": which, "tree": trees[which],
                          "nvidia_smi": smi, **rec}), flush=True)
    if parity:
        differ = sorted(name for name in parity["A"]
                        if parity["A"][name] != parity["B"].get(name))
        print(json.dumps({"parity_identical": not differ, "differ": differ}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
