"""How the Rayleigh-Ritz step's treatment of dropped directions moves the
port's SCF on the GPU.

The band solve's Rayleigh-Ritz (sirius_tpu_torch/solvers/davidson.py::
_rayleigh_ritz) drops near-dependent directions of the subspace and shifts
them above the kept block before cuSOLVER's eigh. This tool runs chip_smoke's
decks with three variants of that step and prints one JSON line per run:

  shift  the port's: 1 + the kept block's Gershgorin bound;
  fixed  the JAX package's fixed 1e6 on the card's eigh;
  host   the fixed 1e6, the reduced matrix's eigh on the host (LAPACK).

Parity decks (2 atoms, NC and US + symmetry): iterations, the largest
energy-term difference to sirius_tpu_torch/data/jax_reference.json, the
last residuals, the share of Rayleigh-Ritz calls with dropped directions.
Full-width decks (16 atoms, 3 iterations): seconds per iteration.

    python3 tools/torch_port_rr_probe.py [--no-full-width]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixed_rr(host: bool, stats: dict):
    """The JAX package's Rayleigh-Ritz (fixed 1e6 shift), its reduced
    eigh on the card or on the host."""
    import torch

    def rr(hsub, ssub, nev):
        s, u = torch.linalg.eigh(ssub)
        smax = torch.amax(s.abs(), dim=-1, keepdim=True)
        good = s > max(50.0 * torch.finfo(s.dtype).eps, 1e-11) * smax
        scale = torch.where(good, torch.rsqrt(torch.where(good, s, 1.0)), 0.0)
        t = u * scale[..., None, :].to(u.dtype)
        at = t.mH @ hsub @ t
        at = at + torch.diag_embed(torch.where(good, 0.0, 1e6).to(at.dtype))
        if host:
            e, y = (x.to(at.device) for x in torch.linalg.eigh(at.cpu()))
        else:
            e, y = torch.linalg.eigh(at)
        stats["calls"] += 1
        stats["dropped"] += int(bool((~good).any()))
        return e[..., :nev], (t @ y)[..., :nev]

    return rr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-full-width", action="store_true",
                    help="skip the 16-atom timings")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_rr_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sirius_tpu_torch.dft.scf import run_scf
    from sirius_tpu_torch.solvers import davidson

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(ROOT, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    run_to_end = {"num_dft_iter": 3, "density_tol": 0.0, "energy_tol": 0.0}
    decks = [("full_width_2atom", cs.make_context(cs.PARITY, cs.TIGHT)),
             ("full_width_2atom_us_sym",
              cs.make_context(cs.PARITY, cs.TIGHT, cs.US_SYM))]
    if not args.no_full_width:
        decks += [("si16_supercell2", cs.make_context(cs.FULL, run_to_end)),
                  ("si16_supercell2_us_sym",
                   cs.make_context(cs.FULL, run_to_end, cs.US_SYM))]
    gpu = f"{torch.cuda.get_device_name(0)} ({cs.nvidia_smi()})"
    port_rr = davidson._rayleigh_ritz
    for variant in ("shift", "fixed", "host"):
        stats = {"calls": 0, "dropped": 0}
        davidson._rayleigh_ritz = (port_rr if variant == "shift"
                                   else fixed_rr(variant == "host", stats))
        try:
            for deck, ctx in decks:
                stats.update(calls=0, dropped=0)
                t0 = time.perf_counter()
                res = run_scf(ctx.cfg, ctx=ctx, device="cuda")
                rec = {"tool": "tools/torch_port_rr_probe.py", "gpu": gpu,
                       "variant": variant, "deck": deck,
                       "seconds": time.perf_counter() - t0,
                       "num_scf_iterations": res["num_scf_iterations"],
                       "iteration_seconds": res["iteration_seconds"]}
                if deck in refs:
                    ref = refs[deck]
                    rec.update(
                        ref_iterations=ref["num_scf_iterations"],
                        max_term_err=max(abs(res["energy"][k] - v)
                                         for k, v in ref["energy"].items()),
                        rms_last=res["rms_history"][-3:])
                if stats["calls"]:
                    rec["rr_calls_with_dropped"] = stats["dropped"] / stats["calls"]
                print(json.dumps(rec), flush=True)
        finally:
            davidson._rayleigh_ritz = port_rr
    return 0


if __name__ == "__main__":
    sys.exit(main())
