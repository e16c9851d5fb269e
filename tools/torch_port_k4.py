"""K4 (the ultrasoft augmentation charge) on the card, in this checkout and
another, in turns: this, other, other, this. For each shape: the event
time (CUDA events, median of 21 samples of 5 launches), the device time of
the work one call launches (torch.profiler) and a hash of the output's
bytes, so two checkouts that compute the same bits show the same hash.

    python3 tools/torch_port_k4.py [--other DIR] [--order this,other,...]
                                   [--plans TG/K ...] [--out FILE]

Shapes: one atom type of chip_smoke.py's 16-atom US cell (291,693 G) with
1 and 2 channels, its spinor cell's 4 (the same G and atoms), and the
54-atom cell (984,161 G) with 1 and 2; nqlm 10. The density matrices are
seeded Hermitian blocks; the inputs are made once, on the CPU, by this
checkout, and handed to each run in a file, and each run's outputs come
back in one.

Besides the times: each shape's bound (chip_smoke.py's count of bytes and
operations), the plain version's time and the einsum yardstick's (phases
built outside the timing), in the first run; and, from this
checkout's kernels/augmentation.py::phase_check, how many (G, atom)
arguments of each cell have a phase of -G that is not the conjugate of
G's bit for bit (K4 sums one (G, -G) row once on that premise).

--plans times this checkout's K4 again at every shape with its plan forced
to each row tile TG and q split K given (where it fits), and says whether
the output keeps the planned launch's bits.

One JSON line a run and shape, one a cell for the phase check, then one a
shape with the times of each checkout and whether their bits agree, then
the card's name and power limit. Two outputs agree where every float64
has the same bits, a +0 against a -0 counted apart (`zero_sign_pairs`):
such a zero adds nothing to a sum with a nonzero term. Exits 1 if the
checkouts' bits differ otherwise, or if a phase differs by more than a
zero's sign.

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
CELLS = {"16 atoms": "FULL", "54 atoms": "GAMMA54"}
# shape: (cell, channels)
SHAPES = {"16 atoms, ns 1": ("16 atoms", 1), "16 atoms, ns 2": ("16 atoms", 2),
          "16 atoms spinor, ns 4": ("16 atoms", 4),
          "54 atoms, ns 1": ("54 atoms", 1), "54 atoms, ns 2": ("54 atoms", 2)}


def smoke():
    """This checkout's chip_smoke.py, loaded by path (another checkout on
    sys.path may hold one of its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str) -> None:
    """The first atom type's K4 tables of both cells and a seeded
    Hermitian density matrix a shape, from this checkout on the CPU."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables

    cs = smoke()
    rng = np.random.default_rng(14)
    out = {}
    for cell, spec in CELLS.items():
        ctx = cs.make_context(getattr(cs, spec), {}, cs.US_SYM)
        aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug,
                                      ctx.beta, "cpu")[0]
        for key in ("millers", "pos", "q", "gidx", "w"):
            out[f"{cell}/{key}"] = aug[key].numpy()
        out[f"{cell}/nrow"] = np.asarray(aug["pairs"].shape[0])
        out[f"{cell}/nbeta"] = np.asarray(ctx.beta.num_beta_total)
    for shape, (cell, ns) in SHAPES.items():
        nbeta = int(out[f"{cell}/nbeta"])
        a = (rng.standard_normal((ns, nbeta, nbeta))
             + 1j * rng.standard_normal((ns, nbeta, nbeta)))
        out[f"{shape}/dm"] = (a + a.conj().transpose(0, 2, 1)) * 0.05
    np.savez(path, **out)


def digest(t) -> str:
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def work(cs, na: int, nqlm: int, ng: int, nrow: int, ns: int,
         nbeta: int) -> dict:
    """Bytes, operations and bound of one launch on nrow (G, -G) rows, as
    chip_smoke.py::check_rho_aug counts them."""
    nbytes = nqlm * ng * 16 + ns * ng * 16 + ng * 12 + ns * nbeta * nbeta * 16
    flops = nrow * na * 7.0 + ng * ns * nqlm * 8.0
    tensor_flops = nrow * na * ns * nqlm * 4.0
    b_ms, b_by = cs.bound(nbytes, flops, tensor_flops=tensor_flops)
    return {"bytes": nbytes, "flops": flops, "tensor_flops": tensor_flops,
            "bound_ms": b_ms, "bound_by": b_by}


def worker(npz: str, tree: str, run: int, outs: str, yardsticks: bool) -> None:
    """Time and hash K4 of the checkout at tree at every shape; with
    yardsticks also the plain version and the einsum."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    import sirius_tpu_torch
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import build

    here = os.path.dirname(os.path.dirname(os.path.abspath(
        sirius_tpu_torch.__file__)))
    assert os.path.samefile(here, tree), (here, tree)
    cs = smoke()
    build.build_all(("augmentation",))
    dev = torch.device("cuda")
    data = np.load(npz)
    takes_pairs = "pairs" in inspect.signature(k45.rho_aug).parameters
    tables, saved = {}, {}
    for cell in CELLS:
        t = {key: torch.as_tensor(data[f"{cell}/{key}"], device=dev)
             for key in ("millers", "pos", "q", "gidx", "w")}
        if takes_pairs:
            t["pairs"] = k45.gvec_pairs(t["millers"])
        tables[cell] = t
    for shape, (cell, ns) in SHAPES.items():
        t = tables[cell]
        dm = torch.as_tensor(data[f"{shape}/dm"], device=dev)
        args = (dm, t["gidx"], t["w"], t["millers"], t["pos"], t["q"])
        kw = {"pairs": t["pairs"]} if takes_pairs else {}

        def fn():
            return k45.rho_aug(*args, **kw)

        out = fn()
        torch.cuda.synchronize()
        saved[shape] = out.cpu().numpy()
        na, nqlm = t["pos"].shape[0], t["q"].shape[0]
        ng = t["millers"].shape[0]
        rec = {"tree": tree, "run": run, "shape": shape, "channels": ns,
               "atoms": na, "nqlm": nqlm, "num_gvec": ng,
               "ms": cs.time_ms(fn),
               "device_ms": cs.device_ms(fn, dev, ("rho_aug",)),
               "sha": digest(out),
               **work(cs, na, nqlm, ng, int(data[f"{cell}/nrow"]), ns,
                      dm.shape[-1])}
        if takes_pairs:
            rec["plan"] = k45.rho_aug_plan(na, nqlm, ns, t["pairs"].shape[0])
        if yardsticks:
            ph = k45.structure_phases(t["millers"], t["pos"])
            dmp = (t["w"][None, None, :]
                   * dm.reshape(ns, -1)[:, t["gidx"].long()].real
                   ).to(torch.complex128)
            rec["plain_ms"] = cs.time_ms(lambda: k45.rho_aug_plain(*args))
            rec["library_ms"] = cs.time_ms(
                lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, t["q"]))
            err = (out - k45.rho_aug_plain(*args)).abs().max()
            rec["max_rel_err_plain"] = float(
                err / k45.rho_aug_plain(*args).abs().max())
            del ph, dmp
        print(json.dumps(rec), flush=True)
        del out
        torch.cuda.empty_cache()
    np.savez(outs, **saved)


def phase_checks(npz: str) -> list[dict]:
    """This checkout's phase check on both cells."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.kernels import augmentation as k45

    data = np.load(npz)
    dev = torch.device("cuda")
    lines = []
    for cell in CELLS:
        millers = torch.as_tensor(data[f"{cell}/millers"], device=dev)
        pos = torch.as_tensor(data[f"{cell}/pos"], device=dev)
        counts = k45.phase_check(millers, pos, k45.gvec_pairs(millers))
        lines.append({"phase_check": cell, "atoms": pos.shape[0],
                      "num_gvec": millers.shape[0], **counts})
    return lines


def forced_plan(k45, tg: int, ksplit: int):
    """rho_aug_plan with the row tile and the q split fixed (None where
    that does not fit)."""
    base = k45.rho_aug_plan

    def plan(na, nqlm, ns, nrow):
        p = dict(base(na, nqlm, ns, nrow))
        shared = k45.rho_aug_layout(ns, nqlm, tg, p["atoms"], ksplit)
        if shared > k45.SHARED_MAX or ns * ksplit * tg > k45.RA_MAX_THREADS \
                or ksplit > nqlm or (ksplit > 1 and p["atom_tiles"] > 1):
            return None
        p.update(tg=tg, ksplit=ksplit, threads=ns * ksplit * tg,
                 shared=shared, row_tiles=-(-nrow // tg))
        return p

    return plan


def plan_sweep(npz: str, labels) -> list[dict]:
    """This checkout's K4 at every shape under each forced plan TG/K."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.kernels import augmentation as k45

    cs = smoke()
    data = np.load(npz)
    dev = torch.device("cuda")
    chosen = k45.rho_aug_plan
    lines = []
    for shape, (cell, ns) in SHAPES.items():
        t = {key: torch.as_tensor(data[f"{cell}/{key}"], device=dev)
             for key in ("millers", "pos", "q", "gidx", "w")}
        pairs = k45.gvec_pairs(t["millers"])
        dm = torch.as_tensor(data[f"{shape}/dm"], device=dev)
        args = (dm, t["gidx"], t["w"], t["millers"], t["pos"], t["q"])
        want = k45.rho_aug(*args, pairs=pairs)
        na, nqlm = t["pos"].shape[0], t["q"].shape[0]
        planned = chosen(na, nqlm, ns, pairs.shape[0])
        for label in labels:
            tg, ksplit = (int(x) for x in label.split("/"))
            plan = forced_plan(k45, tg, ksplit)
            if plan(na, nqlm, ns, pairs.shape[0]) is None:
                continue
            k45.rho_aug_plan = plan
            try:
                def fn():
                    return k45.rho_aug(*args, pairs=pairs)

                got = fn()
                rec = {"plans": label, "shape": shape,
                       "planned": f"{planned['tg']}/{planned['ksplit']}",
                       "ms": cs.time_ms(fn),
                       "device_ms": cs.device_ms(fn, dev, ("rho_aug",)),
                       "same_bits": compare(got.cpu().numpy(),
                                            want.cpu().numpy()) == (0, 0)}
            finally:
                k45.rho_aug_plan = chosen
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    return lines


def compare(a, b) -> tuple[int, int]:
    """(float64 values whose bits differ other than a zero's sign, values
    that are +0 against -0) of two complex128 arrays."""
    import numpy as np

    x = np.ascontiguousarray(a).view(np.float64).ravel()
    y = np.ascontiguousarray(b).view(np.float64).ravel()
    differ = x.view(np.int64) != y.view(np.int64)
    zero = differ & (x == 0.0) & (y == 0.0)
    return int((differ & ~zero).sum()), int(zero.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default="", help="another checkout's root")
    ap.add_argument("--order", default="",
                    help="the runs, comma-separated 'this' / 'other' "
                    "(default: this, or this,other,other,this)")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="forced K4 plans TG/K to time in this checkout")
    ap.add_argument("--out", default="", help="also write the lines here")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--outputs", default="", help=argparse.SUPPRESS)
    ap.add_argument("--yardsticks", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, os.path.abspath(args.tree), args.run,
               args.outputs, args.yardsticks)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k4: CUDA is not available", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other) if args.other else ""
    names = (args.order.split(",") if args.order
             else ["this", "other", "other", "this"] if other else ["this"])
    if "other" in names and not other:
        ap.error("--order names 'other' without --other")
    trees = [ROOT if n == "this" else other for n in names]
    lines, outputs = [], {}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "inputs.npz")
        make_inputs(npz)
        for run, tree in enumerate(trees):
            outs = os.path.join(tmp, f"out{run}.npz")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", npz,
                   "--tree", tree, "--run", str(run), "--outputs", outs]
            # the yardsticks (the same in every checkout) once
            if run == 0:
                cmd.append("--yardsticks")
            proc = subprocess.run(cmd, capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                print(proc.stdout)
                return proc.returncode
            for line in proc.stdout.splitlines():
                lines.append(json.loads(line))
                print(line, flush=True)
            outputs[run] = dict(np.load(outs))
        for rec in phase_checks(npz):
            ok = ok and rec["argument_differs"] == rec["sin_differs"] \
                == rec["cos_differs"] == 0
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        if args.plans:
            sweep = plan_sweep(npz, args.plans)
            ok = ok and all(r["same_bits"] for r in sweep)
            lines += sweep
    summary = []
    for shape in SHAPES:
        rows = [r for r in lines if r.get("shape") == shape and "tree" in r]
        rec = {"shape": shape, "same_bits": True, "zero_sign_pairs": 0,
               "other_bits_differ": 0}
        for run in range(1, len(trees)):
            differ, zero = compare(outputs[0][shape], outputs[run][shape])
            rec["other_bits_differ"] += differ
            rec["zero_sign_pairs"] += zero
        rec["same_bits"] = rec["other_bits_differ"] == 0
        rec["same_hash"] = len({r["sha"] for r in rows}) == 1
        for key in ("bound_ms", "bound_by", "plain_ms", "library_ms"):
            vals = [r[key] for r in rows if key in r]
            if vals:
                rec[key] = vals[0]
        for name in ("this", "other"):
            rs = [r for r in rows
                  if r["tree"] == (ROOT if name == "this" else other)]
            if rs:
                rec[f"{name}_ms"] = [r["ms"] for r in rs]
                rec[f"{name}_device_ms"] = [r["device_ms"] for r in rs]
        ok = ok and rec["same_bits"]
        summary.append(rec)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines + summary:
                f.write(json.dumps(rec) + "\n")
            f.write(smi + "\n")
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
