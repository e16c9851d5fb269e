"""Record the JAX package's SCF results on the decks the PyTorch port is
held to, into sirius_tpu_torch/data/jax_reference.json.

The port's CPU tests and chip_smoke.py compare against this file (the
machine with the GPU has no JAX). Every deck is the synthetic diamond-Si
cell with LDA (X + PZ), Anderson mixing, Gaussian smearing and tight SCF
tolerances, at two shapes: norm-conserving without symmetry ("small",
"full_width_2atom") and ultrasoft with the space group and the irreducible
k-mesh ("small_us_sym", "full_width_2atom_us_sym"). Three Gamma-only decks
at the full-width 2-atom shape take the single-k band solves: the
packed-real Gamma path, norm-conserving ("gamma_nc") and ultrasoft with
symmetry ("gamma_us_sym"), and the chunked-projector path with one atom
per chunk ("chunked_us_sym").

gamma_nc runs a fixed 14 iterations (tolerances that cannot be met): its
partly occupied band triplet at E_F, with no symmetry to average the
density, makes the iteration count to a tolerance irreproducible even in
the JAX package (its own start block perturbed by 1e-13 takes 10, 11 or 12
iterations, and the energy terms of those runs differ by ~1.6e-8 Ha). At a
fixed count past 12 every term is reproducible to ~3e-11 Ha.

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
SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
FULL_2ATOM = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2))
GAMMA_2ATOM = dict(FULL_2ATOM, ngridk=(1, 1, 1))
NC = dict(ultrasoft=False, use_symmetry=False)
US_SYM = dict(ultrasoft=True, use_symmetry=True)
CHUNKED = {"beta_chunked": True, "beta_chunk_size": 1}
FIXED_14 = {"num_dft_iter": 14, "density_tol": 0.0, "energy_tol": 0.0}
# deck name -> (shape, species and symmetry, control settings, SCF
# parameters)
DECKS = {
    "small": (SMALL, NC, {}, TIGHT),
    "full_width_2atom": (FULL_2ATOM, NC, {}, TIGHT),
    "small_us_sym": (SMALL, US_SYM, {}, TIGHT),
    "full_width_2atom_us_sym": (FULL_2ATOM, US_SYM, {}, TIGHT),
    "gamma_nc": (GAMMA_2ATOM, NC, {}, FIXED_14),
    "gamma_us_sym": (GAMMA_2ATOM, US_SYM, {}, TIGHT),
    "chunked_us_sym": (GAMMA_2ATOM, US_SYM, CHUNKED, TIGHT),
}


def run_deck(name: str) -> dict:
    """One JAX SCF on a deck of DECKS, on one CPU device, host SCF path."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from sirius_tpu.dft.scf import run_scf
    from sirius_tpu.testing import synthetic_silicon_context

    shape, kind, control, params = DECKS[name]
    ctx = synthetic_silicon_context(extra_params=dict(params), **kind, **shape)
    ctx.cfg.control.device_scf = "off"
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    res = run_scf(ctx.cfg, ctx=ctx, devices=jax.devices()[:1],
                  keep_state=True)
    deck = {**{k: (list(v) if isinstance(v, tuple) else v)
               for k, v in shape.items()}, **params, **kind}
    if control:
        deck["control"] = dict(control)
    return {
        "deck": deck,
        "num_bands": int(ctx.num_bands),
        "ngk_max": int(ctx.gkvec.ngk_max),
        "num_scf_iterations": int(res["num_scf_iterations"]),
        "converged": bool(res["converged"]),
        "efermi": float(res["efermi"]),
        "electrons": float(np.real(np.asarray(res["_state"]["rho_g"])[0]))
        * float(ctx.unit_cell.omega),
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
