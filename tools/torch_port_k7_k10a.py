"""K7 (X + PZ, unpolarized and polarized), K7b (X + PW92 and X + VWN5,
polarized and unpolarized) and K10a (the GGA gradient boxes) on the card,
in this checkout and another, in turns (default: this, other, other,
this). For each kernel and shape: the event time (CUDA events, median of
21 samples of 5 launches), the device time of the work one call launches
(torch.profiler) and a hash of the output's bytes, so two checkouts that
compute the same bits show the same hash.

    python3 tools/torch_port_k7_k10a.py [--other DIR] [--order this,other,...]
                                        [--moving NAME ...] [--out FILE]

Shapes: the fine boxes of chip_smoke.py's 2-atom parity decks (50^3, where
K7b's decks launch it), 16-atom (96^3) and 54-atom (144^3) cells. K7 and
K7b on the free-atom density in real space with 64 exact zeros and 64
points at 1e-14 (below the threshold): unpolarized; polarized X + PZ at
(rho/2, rho/2) ("K7 polarized zeta 0") and every polarized form at
(0.6 rho, 0.4 rho); K10a on one field and on two (the spin densities of a
+-20 % polarization). The inputs are made once, on the CPU, by this
checkout, and handed to each run in a file.

--moving names the kernels (as the lines name them, e.g. "K7 polarized")
whose bits a change means to move: for those, the summary line gives the
largest difference between the checkouts' outputs relative to each
output's largest magnitude (the first run of each checkout), in place of
a bit check.

One JSON line a run and kernel, then one a kernel and shape with the
median times of each checkout, whether their bits agree and, for a moving
kernel, its max_rel_diff; then the card's name and power limit. Exits 1 if
this checkout's unpolarized X + PZ differs from its polarized launch at
(rho/2, rho/2) (e against e, v_up and v_dn against v), or if the two
checkouts' bits differ in a kernel not named by --moving.

Needs a CUDA card and nvcc; --other DIR is another checkout's root (e.g.
the parent unpacked by `git archive` into a git-ignored directory).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXES = {"50^3": "PARITY", "96^3": "FULL", "144^3": "GAMMA54"}
PW92 = ("XC_LDA_X", "XC_LDA_C_PW")
VWN = ("XC_LDA_X", "XC_LDA_C_VWN")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (another checkout on
    sys.path may hold one of its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str) -> None:
    """The fine-box inputs of the three cells, from this checkout on the
    CPU."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.core.fftgrid import g_to_r
    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g

    cs = smoke()
    out = {}
    for box, spec in BOXES.items():
        ctx = cs.make_context(getattr(cs, spec))
        tables = grid_tables(ctx, "cpu")
        rho0 = torch.as_tensor(initial_density_g(ctx))
        rho = g_to_r(rho0, tables.fft_index, tables.dims).real.reshape(-1)
        rho = rho.clone()
        rho[:64] = 0.0
        rho[64:128] = 1e-14
        out[f"{box}/dims"] = np.asarray(tables.dims)
        out[f"{box}/fft_index"] = tables.fft_index.numpy()
        out[f"{box}/gcart"] = tables.gcart.numpy()
        out[f"{box}/rho_r"] = rho.numpy()
        out[f"{box}/fields"] = torch.stack([0.6 * rho0, 0.4 * rho0]).numpy()
    np.savez(path, **out)


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(npz: str, tree: str, run: int, outputs: str,
           moving: list) -> None:
    """Time and hash K7, K7b and K10a of the checkout at tree; write the
    outputs of the moving kernels to the file outputs."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    import sirius_tpu_torch
    from sirius_tpu_torch.kernels import build
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import xc_gradient as k10

    here = os.path.dirname(os.path.dirname(os.path.abspath(
        sirius_tpu_torch.__file__)))
    assert os.path.samefile(here, tree), (here, tree)
    cs = smoke()
    build.build_all(("lda_xc", "xc_gradient"))
    dev = torch.device("cuda")
    data = np.load(npz)
    takes_table = "box_to_g" in inspect.signature(
        k10.gradient_boxes).parameters
    kept = {}
    for box in BOXES:
        dims = tuple(int(d) for d in data[f"{box}/dims"])
        n = int(np.prod(dims))
        fidx = torch.as_tensor(data[f"{box}/fft_index"], device=dev)
        gcart = torch.as_tensor(data[f"{box}/gcart"], device=dev)
        rho = torch.as_tensor(data[f"{box}/rho_r"], device=dev)
        fields = torch.as_tensor(data[f"{box}/fields"], device=dev)
        half = 0.5 * rho
        nu, nd = 1.2 * half, 0.8 * half
        extra = ()
        if takes_table:
            table = torch.full((n,), -1, dtype=torch.int32, device=dev)
            table[fidx.long()] = torch.arange(fidx.shape[0], dtype=torch.int32,
                                              device=dev)
            extra = (table,)
        calls = {
            "K7 unpolarized": lambda: k7.lda_xc_unpolarized(rho),
            "K7 polarized zeta 0": lambda: k7.lda_xc(half, half),
            "K7 polarized": lambda: k7.lda_xc(nu, nd),
            "K7b PW92 polarized": lambda: k7.lda_xc(nu, nd, PW92),
            "K7b PW92 unpolarized": lambda: k7.lda_xc_unpolarized(rho, PW92),
            "K7b VWN polarized": lambda: k7.lda_xc(nu, nd, VWN),
            "K7b VWN unpolarized": lambda: k7.lda_xc_unpolarized(rho, VWN),
            "K10a 1 field": lambda: k10.gradient_boxes(
                fields[:1], gcart, fidx, n, *extra),
            "K10a 2 fields": lambda: k10.gradient_boxes(
                fields, gcart, fidx, n, *extra),
        }
        outs = {}
        for name, fn in calls.items():
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            outs[name] = out
            if name in moving:
                for k, t in enumerate(x for x in out if x is not None):
                    kept[f"{name}/{box}/{k}"] = t.cpu().numpy()
            rec = {"tree": tree, "run": run, "kernel": name, "box": box,
                   "ms": cs.time_ms(fn),
                   "device_ms": cs.device_ms(fn, dev, ("",)),
                   "sha": digest(*(t for t in out if t is not None))}
            print(json.dumps(rec), flush=True)
        e, v = outs["K7 unpolarized"]
        e_p, vu_p, vd_p = outs["K7 polarized zeta 0"]
        print(json.dumps({"tree": tree, "run": run, "box": box,
                          "pz0_bitwise_polarized": cs.bits_equal(e, e_p)
                          and cs.bits_equal(v, vu_p)
                          and cs.bits_equal(v, vd_p)}), flush=True)
    np.savez(outputs, **kept)


def max_rel_diff(a: dict, b: dict, kernel: str, box: str):
    """The largest |a - b| / max |b| over a moving kernel's outputs at one
    box, between two runs' kept outputs (None if either lacks them)."""
    import numpy as np

    keys = [k for k in a if k.startswith(f"{kernel}/{box}/")]
    if not keys or any(k not in b for k in keys):
        return None
    return max(float(np.max(np.abs(a[k] - b[k])) / np.max(np.abs(b[k])))
               for k in keys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default="", help="another checkout's root")
    ap.add_argument("--order", default="",
                    help="the runs, comma-separated 'this' / 'other' "
                    "(default: this, or this,other,other,this)")
    ap.add_argument("--moving", nargs="*", default=[],
                    help="kernels whose bits are meant to move")
    ap.add_argument("--out", default="", help="also write the lines here")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--outputs", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, os.path.abspath(args.tree), args.run,
               args.outputs, args.moving)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k7_k10a: CUDA is not available", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other) if args.other else ""
    names = (args.order.split(",") if args.order
             else ["this", "other", "other", "this"] if other else ["this"])
    if "other" in names and not other:
        ap.error("--order names 'other' without --other")
    trees = [ROOT if n == "this" else other for n in names]
    lines, kept = [], {}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "inputs.npz")
        make_inputs(npz)
        for run, tree in enumerate(trees):
            outs = os.path.join(tmp, f"out{run}.npz")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", npz,
                 "--tree", tree, "--run", str(run), "--outputs", outs,
                 "--moving", *args.moving],
                capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                print(proc.stdout)
                return proc.returncode
            for line in proc.stdout.splitlines():
                lines.append(json.loads(line))
                print(line, flush=True)
            kept.setdefault(tree, dict(np.load(outs)))
    for rec in lines:
        if rec.get("tree") == ROOT and "pz0_bitwise_polarized" in rec:
            ok = ok and rec["pz0_bitwise_polarized"]
    summary = []
    for key in sorted({(r["kernel"], r["box"]) for r in lines
                       if "kernel" in r}):
        rows = [r for r in lines if (r.get("kernel"), r.get("box")) == key]
        by_tree = {}
        for r in rows:
            by_tree.setdefault(r["tree"], []).append(r)
        rec = {"kernel": key[0], "box": key[1],
               "same_bits": len({r["sha"] for r in rows}) == 1}
        for tree, rs in by_tree.items():
            tag = "this" if tree == ROOT else "other"
            rec[f"{tag}_ms"] = [r["ms"] for r in rs]
            rec[f"{tag}_device_ms"] = [r["device_ms"] for r in rs]
        if key[0] in args.moving:
            rec["max_rel_diff"] = (max_rel_diff(kept[ROOT], kept[other], *key)
                                   if ROOT in kept and other in kept
                                   else None)
        else:
            ok = ok and rec["same_bits"]
        summary.append(rec)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines + summary:
                f.write(json.dumps(rec) + "\n")
            f.write(smi + "\n")
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
