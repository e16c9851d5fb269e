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

Seven more decks carry other functionals and collinear spin (num_mag_dims
1, starting moments of 0.5 mu_B along z on the atoms): "pbe_us_sym" (the
k-point deck with PBE, unpolarized), "pw_us_sym_afm" (X + PW92, moments
+0.5 / -0.5: the antiferromagnetic subgroup of 8 ops, 4 of them spin-flip),
"gamma_pbe_us_sym_fm" (Gamma-only packed path, PBE, +0.5 / +0.5),
"gamma_nc_vwn" and "gamma_nc_pbesol" (Gamma, norm-conserving, X + VWN5 and
PBEsol, a fixed 14 iterations like gamma_nc), and at the small shape
"small_pbe_afm" (k-point, PBE, +0.5 / -0.5) and "small_gamma_pbe_fm"
(Gamma, PBE, +0.5 / +0.5). Polarized decks also record the total and
per-atom moments.

Four decks carry the SCAN meta-GGA (XC_MGGA_X_SCAN + XC_MGGA_C_SCAN, the
k-set band solve with the tau operator), each a fixed iteration count:
"small_scan_nc" (small shape, norm-conserving, 34 iterations),
"small_scan_us_afm" (small shape, ultrasoft + symmetry, moments +0.5 /
-0.5, 28 iterations) and at the full-width 2-atom shape "scan_us_sym"
(ultrasoft + symmetry) and "scan_us_sym_fm" (the same, moments +0.5 /
+0.5), 5 iterations each.

gamma_nc runs a fixed 14 iterations (tolerances that cannot be met): its
partly occupied band triplet at E_F, with no symmetry to average the
density, makes the iteration count to a tolerance irreproducible even in
the JAX package (its own start block perturbed by 1e-13 takes 10, 11 or 12
iterations, and the energy terms of those runs differ by ~1.6e-8 Ha). At a
fixed count past 12 every term is reproducible to ~3e-11 Ha.

The SCAN decks have the same trouble, worse. SCAN's alpha has a kink at
tau = tau_W (max(tau - tau_W, 0)), and points that sit on it flip their
v_tau slope with the rounding: one iteration turns differences of 1e-13
in the density into 1e-7 in v_tau. To a tolerance the JAX package's own
start block perturbed by 1e-13 takes the small AFM deck to 20, 22 or 20
iterations (23 unperturbed) and scan_us_sym to 19 or 19 (26
unperturbed, E_total 3e-9 Ha apart); the small NC deck takes 26 or 30
iterations in the port with 4 or 1 CPU threads; scan_us_sym_fm does not
converge in 40 iterations (its density residual stays near 1e-5), and two
runs that differ by rounding separate past 1e-8 Ha after iteration 8.
So the small decks run fixed counts past the convergence of every run
seen (34 and 28: there every term is reproducible to ~5e-12 and ~4e-10
Ha), the full-width ones a fixed 5 (every term reproducible to ~4e-9 Ha).
No count past convergence serves scan_us_sym: run on, its converged SCF
hops between states ~1e-8 Ha apart in both packages (the JAX package,
converged at 26 with a density residual of 9e-13, jumps at iteration 30
to a residual of 4e-10 and a free energy 8.4e-9 Ha lower; the port on the
CPU at 27; the port on the H100 lands at 26 on the JAX package's
iteration-30 state, E_total 1.1e-10 apart, and at 30 on its converged
one, 4e-11 apart), so a fixed 26 or 30 misses the 1e-8 gate in vxc by
~1.2e-8 one way or the other.

Four decks carry non-collinear magnetism (num_mag_dims 3: spinor bands,
the 2x2 spin-block Hamiltonian, the four-component density; ultrasoft,
time reversal off), each a fixed iteration count past its convergence. At
the small shape of tests/test_noncollinear.py (gk 3.5 / pw 9, 16 spinor
bands, smearing 0.01 Ha): "small_spinor_us" (Gamma only, LDA X + PZ, no
symmetry, orthogonal starting moments (0.5, 0, 0) / (0, 0, 0.5), which
relax to a common axis, 1.414 mu_B; 14 iterations) and
"small_spinor_pbe_us_sym" (2x2x2 mesh, PBE, the 6-op magnetic space group
of the moments (0.3, 0.3, 0.3) on both atoms, 4 k-points; 0.74 mu_B per
component; 20 iterations: at 14 the energies agree to 1e-10 Ha but the
moments, linear in the density's error, only to 1.8e-8). At the parity shape: "spinor_us" (LDA, no symmetry, moments
(0.5, 0, 0) / (0, 0, 0.5), 8 k-points, 18 iterations) and
"spinor_pbe_us_sym" (PBE, the 6-op group, (0.3, 0.3, 0.3) on both atoms,
24 iterations); at that shape the cell is not magnetic and both relax to
moments below 1e-7. A fixed count before convergence is no 1e-8 check: the
Davidson's per-band convergence mask depends on rounding, and the port at
6 iterations sits 1e-8 Ha (LDA) to 4e-8 Ha (PBE) off the JAX package on the
CPU, while from iteration 12 on every term agrees to ~1e-11 Ha. Spinor decks
record the moments as vectors: the total (x, y, z) and one (x, y, z) per
atom. The JAX package's non-collinear driver returns no state, so these
records carry no electron count.

Run from the repository root (CPU, fp64):

    python tools/torch_port_reference.py            # rewrite the JSON
    python tools/torch_port_reference.py --check    # compare, write nothing
    python tools/torch_port_reference.py --decks gamma_nc_vwn  # some decks
    python tools/torch_port_reference.py --spread spinor_us  # noise

--spread runs a spinor deck again with the JAX package's start block
perturbed by a relative 1e-13 (two seeds) and prints how far each run's
moments and energy terms lie from the record: the spread of the JAX
package's own runs of one deck, which sets the moment limit of
chip_smoke.py for a non-magnetic record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

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
FIXED_5 = dict(FIXED_14, num_dft_iter=5)
FIXED_28 = dict(FIXED_14, num_dft_iter=28)
FIXED_34 = dict(FIXED_14, num_dft_iter=34)
SMALL_GAMMA = dict(SMALL, ngridk=(1, 1, 1))
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
SPIN = {"num_mag_dims": 1}
# starting moments (mu_B along z) of the two atoms
FM = [[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]]
AFM = [[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]
# non-collinear: num_mag_dims 3, orthogonal seeds and a canted common axis
NONCOLLINEAR = {"num_mag_dims": 3}
ORTHO = [[0.5, 0.0, 0.0], [0.0, 0.0, 0.5]]
CANTED = [[0.3, 0.3, 0.3], [0.3, 0.3, 0.3]]
US = dict(ultrasoft=True, use_symmetry=False)
# the small shape of tests/test_noncollinear.py
SMALL_SPINOR = dict(gk_cutoff=3.5, pw_cutoff=9.0, ngridk=(2, 2, 2),
                    num_bands=16)
FIXED_14_SMEAR = dict(FIXED_14, smearing_width=0.01)
# deck name -> (shape, species and symmetry, control settings, SCF
# parameters[, starting moments])
DECKS = {
    "small": (SMALL, NC, {}, TIGHT),
    "full_width_2atom": (FULL_2ATOM, NC, {}, TIGHT),
    "small_us_sym": (SMALL, US_SYM, {}, TIGHT),
    "full_width_2atom_us_sym": (FULL_2ATOM, US_SYM, {}, TIGHT),
    "gamma_nc": (GAMMA_2ATOM, NC, {}, FIXED_14),
    "gamma_us_sym": (GAMMA_2ATOM, US_SYM, {}, TIGHT),
    "chunked_us_sym": (GAMMA_2ATOM, US_SYM, CHUNKED, TIGHT),
    "pbe_us_sym": (FULL_2ATOM, US_SYM, {}, dict(TIGHT, xc_functionals=PBE)),
    "pw_us_sym_afm": (FULL_2ATOM, US_SYM, {},
                      dict(TIGHT, xc_functionals=["XC_LDA_X", "XC_LDA_C_PW"],
                           **SPIN), AFM),
    "gamma_pbe_us_sym_fm": (GAMMA_2ATOM, US_SYM, {},
                            dict(TIGHT, xc_functionals=PBE, **SPIN), FM),
    "gamma_nc_vwn": (GAMMA_2ATOM, NC, {},
                     dict(FIXED_14,
                          xc_functionals=["XC_LDA_X", "XC_LDA_C_VWN"])),
    "gamma_nc_pbesol": (GAMMA_2ATOM, NC, {},
                        dict(FIXED_14, xc_functionals=["XC_GGA_X_PBE_SOL",
                                                       "XC_GGA_C_PBE_SOL"])),
    "small_pbe_afm": (SMALL, US_SYM, {},
                      dict(TIGHT, xc_functionals=PBE, **SPIN), AFM),
    "small_gamma_pbe_fm": (SMALL_GAMMA, US_SYM, {},
                           dict(TIGHT, xc_functionals=PBE, **SPIN), FM),
    "small_scan_nc": (SMALL, NC, {}, dict(FIXED_34, xc_functionals=SCAN)),
    "small_scan_us_afm": (SMALL, US_SYM, {},
                          dict(FIXED_28, xc_functionals=SCAN, **SPIN), AFM),
    "scan_us_sym": (FULL_2ATOM, US_SYM, {},
                    dict(FIXED_5, xc_functionals=SCAN)),
    "scan_us_sym_fm": (FULL_2ATOM, US_SYM, {},
                       dict(FIXED_5, xc_functionals=SCAN, **SPIN), FM),
    "small_spinor_us": (dict(SMALL_SPINOR, ngridk=(1, 1, 1)), US, {},
                        dict(FIXED_14_SMEAR, **NONCOLLINEAR), ORTHO),
    "small_spinor_pbe_us_sym": (SMALL_SPINOR, US_SYM, {},
                                dict(FIXED_14_SMEAR, num_dft_iter=20,
                                     xc_functionals=PBE, **NONCOLLINEAR),
                                CANTED),
    "spinor_us": (FULL_2ATOM, US, {},
                  dict(FIXED_14, num_dft_iter=18, **NONCOLLINEAR), ORTHO),
    "spinor_pbe_us_sym": (FULL_2ATOM, US_SYM, {},
                          dict(FIXED_14, num_dft_iter=24, xc_functionals=PBE,
                               **NONCOLLINEAR), CANTED),
}
SPINOR_DECKS = tuple(n for n, spec in DECKS.items()
                     if spec[3].get("num_mag_dims") == 3)


def deck_spec(name: str):
    """(shape, species and symmetry, control, SCF parameters, moments or
    None) of a deck of DECKS."""
    spec = DECKS[name]
    return spec + (None,) * (5 - len(spec))


def run_deck(name: str, perturb_seed: int | None = None) -> dict:
    """One JAX SCF on a deck of DECKS, on one CPU device, host SCF path.
    With perturb_seed (spinor decks only), the start block is perturbed by
    a relative 1e-13 drawn from that seed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from sirius_tpu.dft.scf import run_scf
    from sirius_tpu.testing import synthetic_silicon_context

    shape, kind, control, params, moments = deck_spec(name)
    ctx = synthetic_silicon_context(
        extra_params=dict(params), **kind, **shape,
        moments=None if moments is None else np.asarray(moments))
    ctx.cfg.control.device_scf = "off"
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    spinor = ctx.num_mag_dims == 3
    if perturb_seed is not None:
        import sirius_tpu.dft.scf_nc as scf_nc

        start = scf_nc._initial_spinors
        rng = np.random.default_rng(perturb_seed)

        def perturbed(c):
            psi = start(c)
            return psi * (1.0 + 1e-13 * rng.standard_normal(psi.shape))

        scf_nc._initial_spinors = perturbed
    try:
        # the non-collinear SCF returns no state (scf.py:244-259)
        res = run_scf(ctx.cfg, ctx=ctx, devices=jax.devices()[:1],
                      keep_state=not spinor)
    finally:
        if perturb_seed is not None:
            scf_nc._initial_spinors = start
    deck = {**{k: (list(v) if isinstance(v, tuple) else v)
               for k, v in shape.items()}, **params, **kind}
    if control:
        deck["control"] = dict(control)
    if moments is not None:
        deck["moments"] = moments
    out = {
        "deck": deck,
        "num_bands": int(ctx.num_bands),
        "ngk_max": int(ctx.gkvec.ngk_max),
        "num_scf_iterations": int(res["num_scf_iterations"]),
        "converged": bool(res["converged"]),
        "efermi": float(res["efermi"]),
        "energy": {k: float(v) for k, v in res["energy"].items()},
    }
    if spinor:
        out["num_kpoints"] = int(ctx.gkvec.num_kpoints)
        out["num_symmetry_ops"] = (0 if ctx.symmetry is None
                                   else int(ctx.symmetry.num_ops))
        out["magnetisation"] = {
            "total": [float(x) for x in res["magnetisation"]["total"]],
            "atoms": [[float(x) for x in m]
                      for m in res["magnetisation"]["atoms"]],
        }
        return out
    out["electrons"] = (float(np.real(np.asarray(res["_state"]["rho_g"])[0]))
                        * float(ctx.unit_cell.omega))
    if "magnetisation" in res:
        out["magnetisation"] = {
            "total": float(res["magnetisation"]["total"][2]),
            "atoms": [float(m[2]) for m in res["magnetisation"]["atoms"]],
        }
    return out


def spread(names) -> dict:
    """For each spinor deck, two runs with the start block perturbed
    (seeds 1 and 2) against the record: per run the largest moment
    component and the largest component and energy-term differences."""
    with open(OUT) as f:
        rec = json.load(f)["decks"]
    out = {}
    for name in names:
        if deck_spec(name)[3].get("num_mag_dims") != 3:
            raise ValueError(f"--spread takes spinor decks, not {name}")
        r = rec[name]
        want = np.concatenate([[r["magnetisation"]["total"]],
                               r["magnetisation"]["atoms"]])
        runs = []
        for seed in (1, 2):
            d = run_deck(name, perturb_seed=seed)
            got = np.concatenate([[d["magnetisation"]["total"]],
                                  d["magnetisation"]["atoms"]])
            runs.append({
                "seed": seed, "num_scf_iterations": d["num_scf_iterations"],
                "max_moment_component": float(np.max(np.abs(got))),
                "max_moment_diff": float(np.max(np.abs(got - want))),
                "max_term_diff": max(abs(d["energy"][k] - v)
                                     for k, v in r["energy"].items()),
                "magnetisation": d["magnetisation"]})
        out[name] = {"record_max_moment_component": float(np.max(np.abs(want))),
                     "runs": runs}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the recorded file")
    ap.add_argument("--decks", nargs="+", choices=sorted(DECKS),
                    help="recompute only these decks (the others keep "
                         "their recorded values)")
    ap.add_argument("--spread", nargs="+", choices=SPINOR_DECKS,
                    help="rerun these spinor decks from perturbed starts "
                         "and print their spread, write nothing")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.spread:
        print(json.dumps(spread(args.spread), indent=1))
        return 0
    names = args.decks or list(DECKS)
    out = {"command": COMMAND, "decks": {n: run_deck(n) for n in names}}
    if args.check:
        with open(OUT) as f:
            rec = json.load(f)
        bad = []
        for n, d in out["decks"].items():
            r = rec["decks"][n]
            if r["num_scf_iterations"] != d["num_scf_iterations"]:
                bad.append((n, "iterations"))
            for k, v in d.get("magnetisation", {}).items():
                if np.max(np.abs(np.subtract(r["magnetisation"][k], v))) > 1e-10:
                    bad.append((n, "magnetisation " + k))
            for k, v in d["energy"].items():
                if abs(r["energy"][k] - v) > 1e-10:
                    bad.append((n, k))
        print(json.dumps({"mismatches": bad}))
        return 1 if bad else 0
    if args.decks and os.path.exists(OUT):
        with open(OUT) as f:
            out["decks"] = {**json.load(f)["decks"], **out["decks"]}
    out["decks"] = {n: out["decks"][n] for n in DECKS}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({n: (d["num_scf_iterations"], d["energy"]["total"])
                      for n, d in out["decks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
