"""Two witnesses for the recorded force decks of tools/torch_port_reference.py
that chip_smoke.py does not give, one JSON line a deck, from the root of a
checkout on a machine with a CUDA card:

    python3 tools/torch_port_forces_probe.py same
    python3 tools/torch_port_forces_probe.py records [--decks NAME ...] \
        [--iters N ...]

same: each deck (a few iterations) through chip_smoke.py::stress_card_vs_cpu:
the card's forces and stress against the CPU's on the state the card's
run_scf hands them, term by term, with the seconds of each stress term and
the stress's launches.
records: each deck's run_scf on the card and on the CPU: the largest force
and stress distances of each to the record at the recorded iteration count,
beside the JAX package's own spread over perturbed starts, and the card's
to the CPU's at each count of --iters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the iterations of each deck's run in `same`: the state need not be
# converged
SAME_ITERS = {"forces_nc": 8, "forces_us": 8, "forces_us_sym_2atom": 6,
              "forces_gamma_pbe_fm": 8}


def same_state(name: str, tool, dev) -> dict:
    import chip_smoke as cs

    ctx = cs.deck_context(name, tool)
    ctx.cfg.parameters.num_dft_iter = SAME_ITERS[name]
    t0 = time.perf_counter()
    out = cs.stress_card_vs_cpu(ctx, dev)
    res = out.pop("result")
    return {"deck": name, "iterations": res["num_scf_iterations"],
            "seconds": time.perf_counter() - t0,
            "forces_seconds": res["forces_seconds"],
            "stress_seconds": res["stress_seconds"],
            "stress_term_seconds": res["stress_term_seconds"], **out,
            "forces": res["forces"], "stress": res["stress"]}


def against_record(name: str, tool, ref: dict, iters: int | None) -> dict:
    """The deck's run_scf on the card and the CPU, stopped at `iters`
    iterations (the recorded count if None): each one's distance to the
    record at the recorded count, and the card's to the CPU's."""
    import numpy as np

    import chip_smoke as cs
    from sirius_tpu_torch.dft.scf import run_scf

    out = {"deck": name, "iters": iters or ref["num_scf_iterations"],
           "jax_forces_spread": ref["forces_spread"],
           "jax_stress_spread": ref["stress_spread"]}
    res = {}
    for device in ("cuda", "cpu"):
        ctx = cs.deck_context(name, tool)
        if iters is not None:
            ctx.cfg.parameters.num_dft_iter = iters
        t0 = time.perf_counter()
        r = res[device] = run_scf(ctx.cfg, ctx=ctx, device=device)
        out[device] = {"iterations": r["num_scf_iterations"],
                       "seconds": time.perf_counter() - t0}
        if iters is None:
            out[device]["forces_err"] = float(np.max(np.abs(np.subtract(
                r["forces"], ref["forces"]))))
            out[device]["stress_err"] = float(np.max(np.abs(np.subtract(
                r["stress"], ref["stress"]))))
    a, b = res["cuda"], res["cpu"]
    out["card_vs_cpu"] = {
        "forces": float(np.max(np.abs(np.subtract(a["forces"],
                                                  b["forces"])))),
        "stress": float(np.max(np.abs(np.subtract(a["stress"],
                                                  b["stress"])))),
        "energy": abs(a["energy"]["total"] - b["energy"]["total"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["same", "records"])
    ap.add_argument("--decks", nargs="+", help="`records`: these decks only")
    ap.add_argument("--iters", nargs="+", type=int,
                    help="`records`: stop each run at these iteration counts"
                         " (the recorded count if not given)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_port_forces_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    from sirius_tpu_torch.kernels import build

    tool = cs.reference_tool()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(json.dumps({"gpu": f"{torch.cuda.get_device_name(0)} ({smi})"}),
          flush=True)
    build.build_all()
    if args.mode == "same":
        for name in tool.FORCES_DECKS:
            print(json.dumps(same_state(name, tool, torch.device("cuda"))),
                  flush=True)
        return 0
    with open(tool.OUT) as f:
        refs = json.load(f)["decks"]
    for name in args.decks or tool.FORCES_DECKS:
        for iters in args.iters or [None]:
            print(json.dumps(against_record(name, tool, refs[name], iters)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
