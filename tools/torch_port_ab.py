"""Seconds per SCF iteration of two checkouts of the port, on one card.

Runs chip_smoke.py's full-width runs that carry the band-solve kernels
(full_width_us and its fp32 twin polished as chip_smoke.py polishes it,
full_width_gamma_us and its fp32 twin, full_width_spinor_us) from this
checkout (A) and from another one (B), each in its own process, in the
order A B B A, and prints one JSON line a run: the checkout, each phase's
iteration seconds and peak device memory. Two versions are compared only
inside one call: a card's speed moves between calls.

    python3 tools/torch_port_ab.py --other DIR [--order ABBA]

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

ctx = cs.make_context(cs.FULL, {"num_dft_iter": cs.FULL_ITERS["full_width_us"],
                                **cs.RUN_TO_END}, cs.US_SYM)
_, rms = run("full_width_us", ctx, required=cs.US_KERNELS, with_rms=True)
ctx.cfg.parameters.precision_wf = "fp32"
ctx.cfg.settings.fp32_to_fp64_rms = cs.polish_threshold(rms)
run("full_width_us_fp32", ctx, required=cs.FP32_US_KERNELS,
    deck="si16_supercell2_us_sym",
    electron_tol=cs.fp32_electron_tol(refs, ctx.unit_cell.num_valence_electrons))
del ctx
ctx = cs.make_context(cs.GAMMA54, {"num_dft_iter": cs.FULL_ITERS[
    "full_width_gamma_us"], **cs.RUN_TO_END}, cs.US_SYM)
run("full_width_gamma_us", ctx, required=cs.GAMMA_US_KERNELS,
    deck="si54_supercell3_gamma", path="gamma")
ctx.cfg.parameters.precision_wf = "fp32"
run("full_width_gamma_us_fp32", ctx, required=cs.FP32_GAMMA_US_KERNELS,
    deck="si54_supercell3_gamma", path="gamma",
    electron_tol=cs.fp32_electron_tol(refs, ctx.unit_cell.num_valence_electrons))
del ctx
ctx = cs.magnetic_supercell_context(
    2, cs.FULL, {"num_dft_iter": cs.FULL_ITERS["full_width_spinor_us"],
                 **cs.RUN_TO_END, **cs.NONCOLLINEAR}, cs.US_SYM, cs.CANTED[0])
run("full_width_spinor_us", ctx, required=cs.SPINOR_SYM_KERNELS,
    deck="si16_supercell2_us_sym_spinor", path="kset_nc")
print(json.dumps({"gpu": gpu, "runs": out}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root (B)")
    ap.add_argument("--order", default="ABBA")
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
    for i, which in enumerate(args.order):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[which],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": which, "tree": trees[which],
                          "nvidia_smi": smi, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
