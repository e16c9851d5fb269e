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
PBEsol, a fixed 24 iterations like gamma_nc), and at the small shape
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

gamma_nc runs a fixed 24 iterations (tolerances that cannot be met): its
partly occupied band triplet at E_F, with no symmetry to average the
density, makes the iteration count to a tolerance irreproducible even in
the JAX package (its own start block perturbed by 1e-13 takes 10, 11 or 12
iterations, and the energy terms of those runs differ by ~1.6e-8 Ha). From
iteration 12 to 19 its density residual sits on a plateau near 8e-10,
where the terms still move by up to 5e-8 Ha with rounding (the port on the
card at 14, 4.8e-8 Ha from the record), and from iteration 20 on near
3e-11: at 24 the JAX package's own runs from perturbed starts agree to
4e-10 Ha and the port on the CPU to 3e-10. gamma_nc_vwn and
gamma_nc_pbesol run the same 24.

Two decks run to a tolerance also record the iteration counts of the JAX
package's runs from perturbed starts ("perturbed_iterations", seeds 1 to
6, PERTURBED): at a tolerance the stop turns on |dE| and the residual
crossing their limits, which rounding moves by a few iterations. The port's
count is held to +-1 of the span of the record and these runs.

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

The fp32 decks (precision_wf "fp32", FP32_TWINS) each stand beside an
fp64 twin, the same deck in fp64, and record the JAX package's own
fp32-vs-fp64 gap: per energy term for the record, and the largest term,
electron-count and moment gaps over its fp32 runs, three for a deck in
fp32 throughout (the record and two from starts perturbed by a relative
1e-7, seeds 1 and 2), the record alone for a polished one. A pure-fp32 run
scatters by 1e-5 to 3e-4 Ha per term and ~1e-6 electrons between runs that
differ by rounding, so one sample is no measure of it. The non-collinear
fp32 deck and its twin read their electron count off the last mixed
vector (the JAX package's non-collinear driver returns no state).

Four decks carry the forces and the stress (control.print_forces and
print_stress), each a fixed count past convergence (FORCES_DECKS, said
below at FORCES_ITERS): "forces_nc" and "forces_us" at the shape of
tests/test_forces.py on the packed-real Gamma solve,
"forces_us_sym_2atom" on the k-set solve with the JAX package's fused step
(the record says "fused": true), "forces_gamma_pbe_fm" on the Gamma solve
with PBE and moments +0.5 / +0.5. Their records carry the forces, the
stress, the band solve, and the JAX package's own spread of both over
three runs from starts perturbed by 1e-13 ("forces_spread",
"stress_spread").

Four decks carry the anderson_stable and broyden2 mixers (a control
entry "mixer.type"): the small and the 2-atom ultrasoft decks with the
space group, to TIGHT ("small_us_sym_anderson_stable", ...,
"broyden2_us_sym"). Two decks carry spin-orbit coupling ("so_nc",
"so_us_sym"; FILE_DECKS): the JAX package builds their contexts from the
deck and UPF species file of write_deck_files (its synthetic context takes
no j-resolved species), and their records carry the JAX package's own
spread over three runs from starts perturbed by 1e-13.

Two decks record the JAX package's fused step (control.device_scf
"auto": sirius_tpu/dft/fused.py on one device; FUSED_DECKS): the 2-atom
ultrasoft k-point deck with its 48 ops ("fused_us_sym") and
pw_us_sym_afm's deck ("fused_pw_us_sym_afm"), to TIGHT. Their records
carry the per-iteration scalar record of the JAX package's scf_iteration
events ("scf_scalars", dft/fused.py's [20] slots), read through
sirius_tpu.obs.events; chip_smoke.py's parity_fused_record holds the
port's fused step to them. (A band solve run to a residual of 1e-12 in 60
steps brings the first iterations of two CPU runs together to ~1e-11, but
on the card the Davidson cannot reach that residual, and the card's runs
then wander by 1e-7 from iteration 3 on, host loop and fused step alike.)

Run from the repository root (CPU):

    python tools/torch_port_reference.py            # rewrite the JSON
    python tools/torch_port_reference.py --check    # compare, write nothing
    python tools/torch_port_reference.py --decks gamma_nc_vwn  # some decks
    python tools/torch_port_reference.py --decks forces_nc forces_us \
        forces_us_sym_2atom forces_gamma_pbe_fm  # the force decks
    python tools/torch_port_reference.py --spread spinor_us  # noise
    python tools/torch_port_reference.py --term-spread gamma_nc_vwn \
        [--perturbation 1e-13]

--spread runs a spinor deck again with the JAX package's start block
perturbed by a relative 1e-13 (two seeds) and prints how far each run's
moments and energy terms lie from the record: the spread of the JAX
package's own runs of one deck, which sets the moment limit of
chip_smoke.py for a non-magnetic record. --term-spread does the same for a
collinear deck (the LCAO start block perturbed by --perturbation) and
prints each run's iteration count and the energy term that moved most.
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
FIXED_24 = dict(FIXED_14, num_dft_iter=24)
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
    "gamma_nc": (GAMMA_2ATOM, NC, {}, FIXED_24),
    "gamma_us_sym": (GAMMA_2ATOM, US_SYM, {}, TIGHT),
    "chunked_us_sym": (GAMMA_2ATOM, US_SYM, CHUNKED, TIGHT),
    "pbe_us_sym": (FULL_2ATOM, US_SYM, {}, dict(TIGHT, xc_functionals=PBE)),
    "pw_us_sym_afm": (FULL_2ATOM, US_SYM, {},
                      dict(TIGHT, xc_functionals=["XC_LDA_X", "XC_LDA_C_PW"],
                           **SPIN), AFM),
    "gamma_pbe_us_sym_fm": (GAMMA_2ATOM, US_SYM, {},
                            dict(TIGHT, xc_functionals=PBE, **SPIN), FM),
    "gamma_nc_vwn": (GAMMA_2ATOM, NC, {},
                     dict(FIXED_24,
                          xc_functionals=["XC_LDA_X", "XC_LDA_C_VWN"])),
    "gamma_nc_pbesol": (GAMMA_2ATOM, NC, {},
                        dict(FIXED_24, xc_functionals=["XC_GGA_X_PBE_SOL",
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
# the fp32 wave-function path (precision_wf "fp32"), each deck beside its
# fp64 twin: the polished decks switch to complex128 once the density
# residual falls below 1e-4 (settings.fp32_to_fp64_rms), the others run
# fp32 throughout for a fixed count. Six are the parity decks of
# chip_smoke.py; the "precision_" decks are the deck of
# tests/test_precision.py (gk 3 / pw 7, Gamma only, 8 bands, US without
# symmetry): pure fp32 to that test's fp32 tolerances beside fp64 to its
# fp64 ones, fp32 with the polish beside fp64, and pure fp32 for a fixed 10
# iterations beside fp64 for as many. The polished k-point deck runs to
# TIGHT beside the fp64 full_width_2atom_us_sym; its stop moves with the
# fp32 phase's rounding (the JAX package's runs from starts perturbed by
# 1e-7 stop at 10 to 13 iterations, the record at 12), so it records those
# counts (PERTURBED). At TIGHT the converged energy terms of the single-k
# decks scatter by ~5e-8 Ha between runs that reach the tolerance by
# different paths (the JAX package's polished gamma_us_sym lands 6.2e-8 Ha
# from its fp64 record, and on the precision deck the port's fp64 run
# 4.7e-8 from the JAX package's), which a 1e-8 gate cannot tell from a
# fault: so the polished single-k decks run a fixed 16 iterations, past the
# convergence of both packages, beside fp64 twins of 16, and the polished
# precision deck converges further than TIGHT (TIGHTER), as its twin does
POLISH = {"fp32_to_fp64_rms": 1e-4}
FP32 = {"precision_wf": "fp32"}
FIXED_8 = dict(FIXED_14, num_dft_iter=8)
PRECISION = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8)
TIGHTER = {"num_dft_iter": 60, "density_tol": 1e-11, "energy_tol": 1e-12}
PRECISION_FP32_TOL = {"num_dft_iter": 40, "density_tol": 1e-5,
                      "energy_tol": 1e-5}
PRECISION_FP64_TOL = {"num_dft_iter": 40, "density_tol": 1e-8,
                      "energy_tol": 1e-9}
FIXED_10 = dict(FIXED_14, num_dft_iter=10)
FIXED_16 = dict(FIXED_14, num_dft_iter=16)
DECKS.update({
    "us_sym_fixed8": (FULL_2ATOM, US_SYM, {}, FIXED_8),
    "gamma_us_sym_fixed16": (GAMMA_2ATOM, US_SYM, {}, FIXED_16),
    "chunked_us_sym_fixed16": (GAMMA_2ATOM, US_SYM, CHUNKED, FIXED_16),
    "precision_us": (PRECISION, US, {}, PRECISION_FP64_TOL),
    "precision_us_tight": (PRECISION, US, {}, TIGHTER),
    "precision_us_fixed10": (PRECISION, US, {}, FIXED_10),
    "fp32_us_sym_polish": (FULL_2ATOM, US_SYM, POLISH, dict(TIGHT, **FP32)),
    "fp32_us_sym_fixed8": (FULL_2ATOM, US_SYM, {}, dict(FIXED_8, **FP32)),
    "gamma_us_sym_fp32": (GAMMA_2ATOM, US_SYM, POLISH,
                          dict(FIXED_16, **FP32)),
    "chunked_us_sym_fp32": (GAMMA_2ATOM, US_SYM, dict(CHUNKED, **POLISH),
                            dict(FIXED_16, **FP32)),
    "scan_us_sym_fp32": (FULL_2ATOM, US_SYM, {},
                         dict(FIXED_5, xc_functionals=SCAN, **FP32)),
    "small_spinor_pbe_us_sym_fp32": (
        SMALL_SPINOR, US_SYM, {},
        dict(FIXED_14_SMEAR, num_dft_iter=20, xc_functionals=PBE,
             **NONCOLLINEAR, **FP32), CANTED),
    "precision_us_fp32": (PRECISION, US, {},
                          dict(PRECISION_FP32_TOL, **FP32)),
    "precision_us_fp32_polish": (PRECISION, US, POLISH,
                                 dict(TIGHTER, **FP32)),
    "precision_us_fp32_fixed10": (PRECISION, US, {}, dict(FIXED_10, **FP32)),
})
# forces and stress (control.print_forces and print_stress): the synthetic
# Si cell with atom 1 moved, so that the forces are not zero by symmetry,
# each run for a fixed count past convergence (tolerances that cannot be
# met; FORCES_ITERS). "forces_nc" and "forces_us" are the shape and
# positions of tests/test_forces.py (gk 3.5 / pw 8, Gamma only, 8 bands, no
# symmetry, atom 1 at (0.21, 0.27, 0.23)), norm-conserving and ultrasoft,
# on the packed-real Gamma solve; "forces_us_sym_2atom" the full-width
# 2-atom k-point shape, ultrasoft with the C3v subgroup (12 ops) that atom
# 1 at (0.26, 0.26, 0.26) keeps, on the k-set solve with control.device_scf
# on: the JAX package's fused step, which hands the forces the D of the
# final potential; "forces_gamma_pbe_fm" the full-width Gamma shape, PBE,
# moments +0.5 / +0.5, on the packed-real solve: the JAX package's host
# loop, which hands them the D of its last band solve. Its atom 1 sits at
# the distorted (0.21, 0.27, 0.23): at (0.26, 0.26, 0.26) the collinear
# magnetic group keeps 2 ops, and the minority-spin e pair of the C3 axis,
# partly occupied at E_F, is not averaged, so the band solve's rotation
# within it moves the forces by up to 3.8e-7 Ha/bohr between the JAX
# package's own runs from perturbed starts, at 18, 40, 80 and 100
# iterations alike. Past convergence every deck meets the density residual
# jumps of ROADMAP queue 3 item 10 sooner or later (at 32 iterations the
# distorted FM deck's runs spread by 4.4e-7 Ha/bohr); the counts are the
# last before them in the runs seen, where the runs agree in the forces to
# 1e-8 Ha/bohr. Their records carry the forces, the stress, the band solve,
# whether the fused step ran, and the largest force and stress component
# differences of FORCES_SPREAD_SEEDS runs from starts perturbed by a
# relative 1e-13 (the JAX package's own spread)
FORCES_ITERS = {"forces_nc": 24, "forces_us": 24, "forces_us_sym_2atom": 20,
                "forces_gamma_pbe_fm": 24}
PRINT = {"print_forces": True, "print_stress": True}
FORCES_SMALL = dict(gk_cutoff=3.5, pw_cutoff=8.0, ngridk=(1, 1, 1),
                    num_bands=8, positions=[[0.0, 0.0, 0.0],
                                            [0.21, 0.27, 0.23]])
MOVED = [[0.0, 0.0, 0.0], [0.26, 0.26, 0.26]]
DECKS.update({
    "forces_nc": (FORCES_SMALL, NC, PRINT,
                  dict(FIXED_14, num_dft_iter=FORCES_ITERS["forces_nc"])),
    "forces_us": (FORCES_SMALL, US, PRINT,
                  dict(FIXED_14, num_dft_iter=FORCES_ITERS["forces_us"])),
    "forces_us_sym_2atom": (
        dict(FULL_2ATOM, positions=MOVED), US_SYM,
        dict(PRINT, device_scf="auto"),
        dict(FIXED_14, num_dft_iter=FORCES_ITERS["forces_us_sym_2atom"])),
    "forces_gamma_pbe_fm": (
        dict(GAMMA_2ATOM, positions=FORCES_SMALL["positions"]), US_SYM, PRINT,
        dict(FIXED_14, num_dft_iter=FORCES_ITERS["forces_gamma_pbe_fm"],
             xc_functionals=PBE, **SPIN), FM),
})
FORCES_DECKS = ("forces_nc", "forces_us", "forces_us_sym_2atom",
                "forces_gamma_pbe_fm")
# the JAX package's fused step, its per-iteration records kept
FUSED_CONTROL = {"device_scf": "auto"}
DECKS.update({
    "fused_us_sym": (FULL_2ATOM, US_SYM, FUSED_CONTROL, TIGHT),
    "fused_pw_us_sym_afm": (
        FULL_2ATOM, US_SYM, FUSED_CONTROL,
        dict(TIGHT, xc_functionals=["XC_LDA_X", "XC_LDA_C_PW"], **SPIN), AFM),
})
FUSED_DECKS = ("fused_us_sym", "fused_pw_us_sym_afm")
FORCES_SPREAD_SEEDS = (1, 2, 3)
# the anderson_stable and broyden2 mixers (a "mixer.type" control entry):
# the small and the 2-atom ultrasoft decks with the space group, to TIGHT
for mixer in ("anderson_stable", "broyden2"):
    DECKS.update({
        f"small_us_sym_{mixer}": (SMALL, US_SYM, {"mixer.type": mixer},
                                  TIGHT),
        f"{mixer}_us_sym": (FULL_2ATOM, US_SYM, {"mixer.type": mixer},
                            TIGHT),
    })
# spin-orbit (parameters.so_correction, num_mag_dims 3): decks read from
# files (FILE_DECKS). The JAX package's synthetic context takes no
# j-resolved species, so both packages build these contexts from the deck
# and the UPF species file that sirius_tpu_torch/testing.py::write_deck
# writes: synthetic_silicon_species(spin_orbit=True), the l = 1 beta split
# into j = 1/2 and 3/2 with distinct radial functions. At gk 3 / pw 7,
# Gamma only, 16 spinor bands, smearing 0.01 Ha: "so_nc" (norm-conserving,
# no symmetry, orthogonal starting moments, which relax to a common axis
# that the spin-orbit term pins) and "so_us_sym" (ultrasoft with four
# augmentation channels, the magnetic group of the canted moments), each a
# fixed 20 iterations past convergence. Their records carry the JAX
# package's own spread over three runs from starts perturbed by 1e-13
# (SO_SPREAD_SEEDS): the largest energy-term and moment-component
# differences from the record ("term_spread", "moment_spread").
SO_SHAPE = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=16)
SO = dict(FIXED_14_SMEAR, num_dft_iter=20, so_correction=True,
          **NONCOLLINEAR)
DECKS.update({
    "so_nc": (SO_SHAPE, dict(NC, spin_orbit=True), {}, SO, ORTHO),
    "so_us_sym": (SO_SHAPE, dict(US_SYM, spin_orbit=True), {}, SO, CANTED),
})
FILE_DECKS = ("so_nc", "so_us_sym")
SO_SPREAD_SEEDS = (1, 2, 3)
# each fp32 deck's fp64 twin: the same deck in fp64
FP32_TWINS = {
    "fp32_us_sym_polish": "full_width_2atom_us_sym",
    "fp32_us_sym_fixed8": "us_sym_fixed8",
    "gamma_us_sym_fp32": "gamma_us_sym_fixed16",
    "chunked_us_sym_fp32": "chunked_us_sym_fixed16",
    "scan_us_sym_fp32": "scan_us_sym",
    "small_spinor_pbe_us_sym_fp32": "small_spinor_pbe_us_sym",
    "precision_us_fp32": "precision_us",
    "precision_us_fp32_polish": "precision_us_tight",
    "precision_us_fp32_fixed10": "precision_us_fixed10",
}
# decks run to a tolerance whose records carry the iteration counts of the
# JAX package's runs from starts perturbed (seeds PERTURBED_SEEDS) by a
# relative size at the rounding of the deck's band solve
PERTURBED = {"fp32_us_sym_polish": 1e-7, "gamma_pbe_us_sym_fm": 1e-13}
PERTURBED_SEEDS = range(1, 7)
SPINOR_DECKS = tuple(n for n, spec in DECKS.items()
                     if spec[3].get("num_mag_dims") == 3
                     and n not in FP32_TWINS and n not in FILE_DECKS)


def deck_spec(name: str):
    """(shape, species and symmetry, control, SCF parameters, moments or
    None) of a deck of DECKS."""
    spec = DECKS[name]
    return spec + (None,) * (5 - len(spec))


def apply_control(cfg, control: dict) -> None:
    """Set a deck's control entries on a config: "section.key" on that
    section (mixer.type), else the settings field of that name where there
    is one (fp32_to_fp64_rms), else the control field. Works on either
    package's config."""
    for key, value in control.items():
        section, _, name = key.rpartition(".")
        if section:
            target = getattr(cfg, section)
        elif hasattr(cfg.settings, key):
            target = cfg.settings
        else:
            target = cfg.control
        setattr(target, name, value)


def write_deck_files(name: str, directory: str, fmt: str = "upf") -> str:
    """Write a deck of FILE_DECKS into directory (sirius.json and its
    species file, sirius_tpu_torch/testing.py::write_deck) and return the
    deck's path; either package builds its context from it with
    SimulationContext.create(load_config(path), directory)."""
    from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                          synthetic_silicon_species,
                                          write_deck)

    shape, kind, control, params, moments = deck_spec(name)
    kind = dict(kind)
    species = synthetic_silicon_species(
        ultrasoft=kind.pop("ultrasoft"),
        spin_orbit=kind.pop("spin_orbit", False))
    deck = synthetic_silicon_deck(
        **shape, **kind, extra_params=dict(params),
        moments=None if moments is None else np.asarray(moments))
    return write_deck(directory, deck, species, fmt=fmt)


def twin_gap(runs: list, twin: dict) -> dict:
    """The JAX package's own fp32-vs-fp64 gap on a deck, from its fp32 runs
    (the record first, then any from perturbed starts) against the fp64
    twin: the record's gap per energy term, and over all the runs the
    largest |term gap|, |electron-count gap| and moment-component gap."""
    def moments(r):
        return np.concatenate([np.ravel(r["magnetisation"]["total"]),
                               np.ravel(r["magnetisation"]["atoms"])])

    rec = runs[0]
    out = {"twin_gap": {k: v - twin["energy"][k]
                        for k, v in rec["energy"].items()},
           "twin_max_gap": max(abs(r["energy"][k] - v) for r in runs
                               for k, v in twin["energy"].items()),
           "twin_runs": len(runs)}
    if "electrons" in rec and "electrons" in twin:
        out["twin_electron_gap"] = max(abs(r["electrons"] - twin["electrons"])
                                       for r in runs)
    if "magnetisation" in rec:
        out["twin_max_moment_gap"] = max(
            float(np.max(np.abs(moments(r) - moments(twin)))) for r in runs)
    return out


def is_polished(name: str) -> bool:
    """An fp32 deck with the fp32_to_fp64_rms switch."""
    return deck_spec(name)[2].get("fp32_to_fp64_rms", 0) > 0


def run_deck(name: str, perturb_seed: int | None = None,
             perturbation: float = 1e-13) -> dict:
    """One JAX SCF on a deck of DECKS, on one CPU device, host SCF path.
    With perturb_seed, the start block (the LCAO block, or the spinors of
    a non-collinear deck) is perturbed by a relative `perturbation` drawn
    from that seed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from sirius_tpu.dft.scf import run_scf
    from sirius_tpu.testing import synthetic_silicon_context

    shape, kind, control, params, moments = deck_spec(name)
    if name in FILE_DECKS:
        import tempfile

        from sirius_tpu.config.schema import load_config
        from sirius_tpu.context import SimulationContext

        with tempfile.TemporaryDirectory() as tmp:
            path = write_deck_files(name, tmp)
            ctx = SimulationContext.create(load_config(path), tmp)
    else:
        ctx = synthetic_silicon_context(
            extra_params=dict(params), **kind, **shape,
            moments=None if moments is None else np.asarray(moments))
    ctx.cfg.control.device_scf = "off"
    apply_control(ctx.cfg, control)
    spinor = ctx.num_mag_dims == 3
    if perturb_seed is not None:
        import sirius_tpu.dft.scf as scf_mod
        import sirius_tpu.dft.scf_nc as scf_nc

        module, attr = ((scf_nc, "_initial_spinors") if spinor
                        else (scf_mod, "_initial_subspace"))
        start = getattr(module, attr)
        rng = np.random.default_rng(perturb_seed)

        def perturbed(c):
            psi = start(c)
            return psi * (1.0 + perturbation * rng.standard_normal(psi.shape))

        setattr(module, attr, perturbed)
    # the non-collinear SCF returns no state (scf.py:244-259): the electron
    # count of an fp32 deck or twin is read off its last mixed vector
    import sirius_tpu.dft.mixer as mixer_mod

    mix = mixer_mod.Mixer.mix
    mixed = []
    count_nc = spinor and (name in FP32_TWINS or name in FP32_TWINS.values())
    if count_nc:
        def keep(self, *args, **kwargs):
            mixed.append(mix(self, *args, **kwargs))
            return mixed[-1]

        mixer_mod.Mixer.mix = keep
    import tempfile

    from sirius_tpu.obs import events

    tmp = tempfile.TemporaryDirectory()
    if name in FUSED_DECKS:
        events.configure(os.path.join(tmp.name, "events.jsonl"))
    try:
        res = run_scf(ctx.cfg, ctx=ctx, devices=jax.devices()[:1],
                      keep_state=not spinor)
        scalars = ([e["scalars"] for e in events.read_events(
            events.path(), "scf_iteration")] if name in FUSED_DECKS else None)
    finally:
        if name in FUSED_DECKS:
            events.close()
        tmp.cleanup()
        if perturb_seed is not None:
            setattr(module, attr, start)
        mixer_mod.Mixer.mix = mix
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
        if count_nc:
            out["electrons"] = (float(np.real(np.asarray(mixed[-1])[0]))
                                * float(ctx.unit_cell.omega))
        return out
    out["electrons"] = (float(np.real(np.asarray(res["_state"]["rho_g"])[0]))
                        * float(ctx.unit_cell.omega))
    if scalars is not None:
        out["scf_scalars"] = [[float(x) for x in rec] for rec in scalars]
    if "forces" in res:
        from sirius_tpu.utils.profiler import timer_report

        out["forces"] = [[float(x) for x in row] for row in res["forces"]]
        out["stress"] = [[float(x) for x in row] for row in res["stress"]]
        # the single-k decks at Gamma take the packed-real solve
        # (control.reduce_gvec), the others the k-set solve; timer_report is
        # reset at every run_scf entry and names the fused step's timers
        gamma = (ctx.gkvec.num_kpoints == 1 and ctx.cfg.control.reduce_gvec
                 and float(np.abs(ctx.gkvec.kpoints[0]).max()) < 1e-12)
        out["band_solve"] = "gamma" if gamma else "kset"
        out["fused"] = any("fused" in k for k in timer_report())
    if "magnetisation" in res:
        out["magnetisation"] = {
            "total": float(res["magnetisation"]["total"][2]),
            "atoms": [float(m[2]) for m in res["magnetisation"]["atoms"]],
        }
    return out


def forces_spreads(rec: dict, name: str) -> dict:
    """The JAX package's own spread on a force deck: the largest force and
    stress component differences between the record and its runs from
    starts perturbed by a relative 1e-13 (FORCES_SPREAD_SEEDS)."""
    runs = [run_deck(name, perturb_seed=seed) for seed in FORCES_SPREAD_SEEDS]
    return {
        "forces_spread": max(float(np.max(np.abs(np.subtract(
            r["forces"], rec["forces"])))) for r in runs),
        "stress_spread": max(float(np.max(np.abs(np.subtract(
            r["stress"], rec["stress"])))) for r in runs),
        "spread_seeds": list(FORCES_SPREAD_SEEDS)}


def so_spreads(rec: dict, name: str) -> dict:
    """The JAX package's own spread on a spin-orbit deck: the largest
    energy-term and moment-component differences between the record and
    its runs from starts perturbed by a relative 1e-13 (SO_SPREAD_SEEDS)."""
    runs = [run_deck(name, perturb_seed=seed) for seed in SO_SPREAD_SEEDS]

    def moments(r):
        return np.concatenate([np.ravel(r["magnetisation"]["total"]),
                               np.ravel(r["magnetisation"]["atoms"])])

    return {
        "term_spread": max(abs(r["energy"][k] - v) for r in runs
                           for k, v in rec["energy"].items()),
        "moment_spread": max(float(np.max(np.abs(moments(r) - moments(rec))))
                             for r in runs),
        "spread_iterations": [r["num_scf_iterations"] for r in runs],
        "spread_seeds": list(SO_SPREAD_SEEDS)}


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


def term_spread(names, perturbation: float = 1e-13) -> dict:
    """For each collinear deck, two runs with the JAX package's start block
    perturbed by a relative `perturbation` (seeds 1 and 2) against the
    record: the
    iteration count, and the energy term that moved most and by how much.
    A gap between the port and the record that the JAX package's own
    perturbed runs reproduce follows the trajectory, not the code."""
    with open(OUT) as f:
        rec = json.load(f)["decks"]
    out = {}
    for name in names:
        if deck_spec(name)[3].get("num_mag_dims") == 3:
            raise ValueError(f"--term-spread takes collinear decks, not {name}")
        r = rec[name]
        runs = []
        for seed in (1, 2):
            d = run_deck(name, perturb_seed=seed, perturbation=perturbation)
            diff = {k: d["energy"][k] - v for k, v in r["energy"].items()}
            worst = max(diff, key=lambda k: abs(diff[k]))
            run = {"seed": seed,
                   "num_scf_iterations": d["num_scf_iterations"],
                   "max_term": worst, "max_term_diff": diff[worst],
                   "total_diff": diff["total"]}
            if "magnetisation" in d:
                run["total_moment_diff"] = (d["magnetisation"]["total"]
                                            - r["magnetisation"]["total"])
            runs.append(run)
        out[name] = {"record_iterations": r["num_scf_iterations"],
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
    ap.add_argument("--term-spread", nargs="+",
                    choices=[n for n, spec in DECKS.items()
                             if spec[3].get("num_mag_dims") != 3],
                    help="rerun these collinear decks from perturbed starts "
                         "and print how far their terms move, write nothing")
    ap.add_argument("--perturbation", type=float, default=1e-13,
                    help="relative size of the --term-spread perturbation")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.spread:
        print(json.dumps(spread(args.spread), indent=1))
        return 0
    if args.term_spread:
        print(json.dumps(term_spread(args.term_spread, args.perturbation),
                         indent=1))
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
            for k in ("forces", "stress"):
                if k in d and np.max(np.abs(np.subtract(r[k], d[k]))) > 1e-10:
                    bad.append((n, k))
        print(json.dumps({"mismatches": bad}))
        return 1 if bad else 0
    if args.decks and os.path.exists(OUT):
        with open(OUT) as f:
            out["decks"] = {**json.load(f)["decks"], **out["decks"]}
    out["decks"] = {n: out["decks"][n] for n in DECKS}
    for name, twin in FP32_TWINS.items():
        if name not in names and "twin" in out["decks"][name]:
            continue
        # the JAX package's own fp32 scatter: a deck in fp32 throughout is
        # run twice more from starts perturbed by a relative 1e-7 (seeds 1,
        # 2), and its gaps are the largest over the three runs
        runs = [out["decks"][name]] + ([] if is_polished(name) else [
            run_deck(name, perturb_seed=seed, perturbation=1e-7)
            for seed in (1, 2)])
        out["decks"][name].update(twin=twin,
                                  **twin_gap(runs, out["decks"][twin]))
    for name in FORCES_DECKS:
        if name not in names and "forces_spread" in out["decks"][name]:
            continue
        out["decks"][name].update(forces_spreads(out["decks"][name], name))
    for name in FILE_DECKS:
        if name not in names and "term_spread" in out["decks"][name]:
            continue
        out["decks"][name].update(so_spreads(out["decks"][name], name))
    for name, size in PERTURBED.items():
        if name not in names and "perturbed_iterations" in out["decks"][name]:
            continue
        out["decks"][name]["perturbed_iterations"] = [
            run_deck(name, perturb_seed=seed,
                     perturbation=size)["num_scf_iterations"]
            for seed in PERTURBED_SEEDS]
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({n: (d["num_scf_iterations"], d["energy"]["total"])
                      for n, d in out["decks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
