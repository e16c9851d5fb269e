"""Record the JAX package's SCF results on the decks the PyTorch port is
held to, into sirius_tpu_torch/data/jax_reference.json.

The port's CPU tests and chip_smoke.py compare against this file (the
machine with the GPU has no JAX). Both decks are the synthetic diamond-Si
cell, norm-conserving, no symmetry, LDA (X + PZ), Anderson mixing, Gaussian
smearing, with tight SCF tolerances.

Run from the repository root (CPU, fp64):

    python tools/torch_port_reference.py            # rewrite the JSON
    python tools/torch_port_reference.py --check    # compare, write nothing
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
COMMAND = "python tools/torch_port_reference.py"

TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
DECKS = {
    "small": dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8),
    "full_width_2atom": dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2)),
}


def run_deck(name: str) -> dict:
    """One JAX SCF on a deck of DECKS, on one CPU device, host SCF path."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from sirius_tpu.dft.scf import run_scf
    from sirius_tpu.testing import synthetic_silicon_context

    ctx = synthetic_silicon_context(
        ultrasoft=False, use_symmetry=False, extra_params=dict(TIGHT),
        **DECKS[name])
    ctx.cfg.control.device_scf = "off"
    res = run_scf(ctx.cfg, ctx=ctx, devices=jax.devices()[:1])
    return {
        "deck": {**{k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in DECKS[name].items()},
                 **TIGHT, "ultrasoft": False, "use_symmetry": False},
        "num_bands": int(ctx.num_bands),
        "ngk_max": int(ctx.gkvec.ngk_max),
        "num_scf_iterations": int(res["num_scf_iterations"]),
        "converged": bool(res["converged"]),
        "efermi": float(res["efermi"]),
        "energy": {k: float(v) for k, v in res["energy"].items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the recorded file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    out = {"command": COMMAND, "decks": {n: run_deck(n) for n in DECKS}}
    if args.check:
        with open(OUT) as f:
            rec = json.load(f)
        bad = []
        for n, d in out["decks"].items():
            r = rec["decks"][n]
            if r["num_scf_iterations"] != d["num_scf_iterations"]:
                bad.append((n, "iterations"))
            for k, v in d["energy"].items():
                if abs(r["energy"][k] - v) > 1e-10:
                    bad.append((n, k))
        print(json.dumps({"mismatches": bad}))
        return 1 if bad else 0
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({n: (d["num_scf_iterations"], d["energy"]["total"])
                      for n, d in out["decks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
