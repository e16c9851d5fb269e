"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of sirius_tpu. Phases, each printing JSON lines:

1. device and build: the card's name and power limit; the kernel sources
   of sirius_tpu_torch/csrc/ compiled by nvcc, one process each, all at
   once; the S-subspace matrix with empty rows that cuSOLVER's heevd could
   not solve (eigh_empty_rows): cuSOLVER's Jacobi, the band solve's retry,
   against LAPACK's eigenvalues, and the Rayleigh-Ritz on it against the
   CPU's;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the parity decks and of the full-width decks (norm-conserving: K1,
   K2, K3, K7; ultrasoft + symmetry: K1c, K4, K5, K6; Gamma packed-real:
   K8a, K8b, K1c in real mode, K2 on float64 blocks; chunked projectors:
   K9; the XC kernels at the fine boxes of the 16- and 54-atom cells: K7
   for X + PZ (unpolarized, its zeta = 0 kernel, also bit for bit against
   the polarized kernel at (rho/2, rho/2)), K7b for X + PW92 and X + VWN5,
   K7g for PBE and PBEsol and K7s for SCAN (each set its own
   instantiation) and the three kernels' runtime-mask instantiation on a
   list no set covers, each polarized and unpolarized, on densities with
   dead channels and fully polarized points, K10a (bit for bit its plain
   version on two fields and on one) and K10b, and K6 on an axial
   field; the tau
   operator's K11a and K11b at the 16-atom coarse box; the non-collinear
   kernels at the 2-atom and 16-atom spinor decks: K12a, K12b, K6v and K4
   on four channels; and the fp32 instantiations, at the full-width shapes
   of their fp64 rows and held to 1e-5 relative: K1, K1c, K2 and K3 on
   complex64 at the 16-atom US deck, K8a, K8b, K1c real and K2 on float32
   packed blocks at 54 atoms, K9 at 54 atoms and 16 a chunk, K11a and K11b
   at the 16-atom coarse box, K12a on the spinor k-set block and K12b on
   one k-point's); K4 also at the 54-atom Gamma cell on one and two
   channels (check_kernels_aug54), each K4 record with its plan and the
   card's check that the phase of -G is the conjugate of G's bit for bit
   (raising otherwise), and at the 16-atom US shape on one strained table
   set of the stress (eps_xy = 1e-5) against the host rho_aug_g copy
   (check_rho_aug_strained); K5 also at the 54-atom Gamma cell on one and two
   channels (records only) and on the spinor deck's four channels, each
   launched twice on the same inputs for a bitwise-equal D; every record
   carries the device time of the work one call launches, from
   torch.profiler, beside the event time (device_ms); K1c and K8b record
   whether they are bitwise their plain versions (K8b raises if not), K8b
   its launch plan and K9 its grid;
   K6 also at the 54-atom Gamma cell (1296 ops), where its yardstick
   cannot be built; every K6 and K6v record holds the factorised kernel
   against the unfactorised plain version on a random field too, and
   carries the group's factorisation (num_translations, num_reps,
   num_live) and the unfactorised sum's operations bound; every K2 record
   its cluster size; before them, the edge shapes of the redesigned K1c,
   K5, K8b, K10a, K2 and K7 (check_kernel_edges: odd row lengths, views off
   a 16-byte boundary, G counts off every tile and chunk, 1, 2 and 4
   channels, more atoms than one launch, K8b's two instantiations on a half
   row tile, one row and padding slots, K10a bit for bit on 1, 2 and 3
   fields, on a box of 1001 slots and one of 3, a G at the last slot, K2's
   four instantiations at rows just over and
   under its cluster threshold, with and without w, K4 at K4_EDGES on 1, 2
   and 4 channels (G below one row tile and off it, one atom, the smaller
   row tile, atom tiles, nqlm 3 and 15, q split over two threads a row,
   G = 0 last, into a given out);
   every K7, K7b, K7g and K7s
   instantiation at one point, a point count off the block, all points
   dead, sigma = 0 at zeta = +-1, fully polarized points with gradients,
   zeta within a few ulp of +-1 on live channels, n_up = n_dn (where
   polarized X + PZ must be the zeta = 0 kernel's bits) and, for SCAN,
   alpha at 1; unpolarized X + PZ at one point, off the block, all dead
   and at and just below rho = 2 DENS_TH, also bit for bit against the
   polarized kernel): error,
   kernel time (CUDA events, median of 21 samples of 5 launches after
   warm-up), the plain version's time, a one-call PyTorch yardstick where
   one exists (library_ms), and the least time the card could take
   (bound_ms);
3. parity SCF: the 2-atom full-width decks, norm-conserving without
   symmetry (parity_scf) and ultrasoft with the space group
   (parity_scf_us), and the Gamma-only 2-atom decks of the single-k band
   solves (parity_scf_gamma_nc, parity_scf_gamma_us,
   parity_scf_chunked_us), and the decks of other functionals and
   collinear spin (parity_scf_pbe_us: PBE on the k-point US + symmetry
   deck; parity_scf_pw_us_afm: X + PW92, moments +0.5 / -0.5, 8 ops of
   which 4 flip the spin; parity_scf_gamma_pbe_us_fm: Gamma, PBE, moments
   +0.5 / +0.5; parity_scf_gamma_nc_vwn and parity_scf_gamma_nc_pbesol:
   Gamma, NC, a fixed 24 iterations like gamma_nc; parity_scf_scan_us and
   parity_scf_scan_us_fm: SCAN on the k-point US + symmetry deck,
   unpolarized and +0.5 / +0.5), and the non-collinear decks of the spinor
   k-set solve (parity_scf_small_spinor_us and
   parity_scf_small_spinor_pbe_us_sym, magnetic; parity_scf_spinor_us and
   parity_scf_spinor_pbe_us_sym at the parity shape, which relax to no
   moment; spinor_moment_errors says what of the moments is compared),
   against the JAX package's recorded energies and moments
   (sirius_tpu_torch/data/jax_reference.json), and the six fp32 decks
   against the JAX package's fp64 twin of each (parity_scf_fp32: the
   polished ones to 1e-8, the others within 4x the JAX package's own fp32
   scatter), every fp32 band solve launching only fp32 instantiations;
   and the recorded force decks with control.print_forces and print_stress
   (parity_forces_nc and parity_forces_us: the shape of tests/test_forces.py
   on the Gamma solve; parity_forces_us_sym_2atom: the full-width 2-atom
   k-point deck, US with atom 1 moved along (111); parity_forces_gamma_pbe_fm:
   Gamma, PBE, +0.5 / +0.5), each held to its record at the energy gates
   and at 1e-6 Ha/bohr per force and 1e-7 Ha/bohr^3 per stress component,
   printed beside the JAX package's own spread, its stress launching K1,
   its XC kernel, K10a (GGA) and K4 (US) on the card; and the stress's
   other XC forms (unpolarized PBE, polarized PW92, unpolarized VWN) on
   small decks, the card against the CPU on one state to 1e-10
   (stress_form_*);
4. full-width runs with tolerances that cannot be met, so every iteration
   runs: the 16-atom Si supercell, norm-conserving (full_width, 3 SCF
   iterations) and ultrasoft with its 384 space-group ops (full_width_us,
   6 iterations); the 54-atom Gamma-only supercell, ultrasoft with its
   1296 space-group ops, through the packed-real Gamma solve
   (full_width_gamma_us, 4 iterations) and through the chunked projectors
   with 16 atoms a chunk (full_width_chunked_us, 4 iterations), and the
   same cell spin-polarized with PBE and +0.5 on every atom through the
   packed-real solve, one spin at a time (full_width_gamma_pbe_fm, 4
   iterations); the 16-atom ultrasoft cell with SCAN on the k-set solve
   with the tau operator (full_width_scan_us, 4 iterations); the 16-atom
   ultrasoft cell non-collinear with (0.3, 0.3, 0.3) on every atom, its 48
   magnetic ops and 4 k-points (full_width_spinor_us, 4 iterations); then
   the fp32 path at full width: the 16-atom US run polished to fp64 after
   iteration 3 or 4 (full_width_us_fp32, the switch's residual taken from
   full_width_us), the 54-atom packed-real and the 16-atom spinor runs in
   fp32 throughout (full_width_gamma_us_fp32, full_width_spinor_us_fp32);
   the forces and stress at full width (full_width_forces_us): the 16-atom
   US cell with atom 0 moved by 0.01 along fractional x, run to a tolerance
   with forces and stress on, then at +-2e-3 bohr along x of atom 0: F[0, 0]
   against the central difference of the free energy to 5e-5 Ha/bohr, the
   net force to 1e-5, the forces and stress seconds, the stress's launches;
   the 16-atom ultrasoft non-collinear cell with the spin-orbit species
   (full_width_spinor_so_us, 4 iterations), and the host half of its
   iteration, the D blocks and the density matrix's rotation, timed alone
   at its shapes (spin_orbit_host_step);
   kernel launches per iteration and per band solve, the precision and
   seconds of each iteration, peak device memory, electron count, total
   moment, finite energies;
5. the file entry points, each in a temporary working directory: the
   sirius-scf-torch CLI on the 2-atom ultrasoft + symmetry parity deck
   written with its species as UPF, --test_against an output.json made
   from that deck's record (entry_point_cli: exit 0, TEST PASSED, every
   term within 1e-8 Ha of the record); the 16-atom ultrasoft cell of
   full_width_us written as a deck with UPF species and run through
   run_scf_from_file (full_width_us_from_file: energies and iteration
   count bit for bit those of the in-memory full_width_us run); the
   spin-orbit decks read from their files (parity_scf_so_nc,
   parity_scf_so_us_sym: every term within 1e-8 Ha, every moment
   component within 1e-6 of the records), and the 2-atom ultrasoft deck
   mixed by anderson_stable and broyden2 (parity_scf_anderson_stable,
   parity_scf_broyden2); the whole run's seconds (total).

The fused SCF step (dft/fused.py; every deck that fuses: the k-set
solve, no mGGA, linear or Anderson mixing): K13 (the Fermi level), K14a /
K14b (the device mixer's Gram pass, and its solve, update and ring push)
and K15 (the scalar record) against their plain versions at the 16-atom US
shapes (records, check_fused_kernels; K14a's yardstick the host Gram
product of dft/mixer.py::Mixer), then at their edges: K13 for each
smearing kind at the deck's evals, with every band full (occupations and
entropy held; mu sits on a plateau of the count there for the monotone
kinds, and its distance is printed) and with a level degenerate at mu; K14 at history counts 0 and 3,
the wrapped ring, a 64-row ring (the most the solve takes), a NaN in a
residual row and in x_new (the same NaN
entries and fallback as the plain version); K15 with a NaN in veff
(S_FINITE 0). parity_fused_record_us_sym and _pw_us_sym_afm run the
reference tool's FUSED_DECKS with the step from K13 to the record read
under torch.cuda.set_sync_debug_mode("error") (any host sync fails the
phase), each iteration's record held to the JAX package's (energy slots
and rms within 1e-6 at every iteration both ran, S_FINITE 1, electrons
within 1e-8, the ledger below 1e-10), the terms within 1e-8 Ha. fused_ab_us runs full_width_us's cell
with control.device_scf off and auto in turns (off, auto, auto, off):
seconds an iteration, and host syncs an iteration counted under
set_sync_debug_mode("warn"). Every fused deck must launch K13, K14a, K14b
and K15; every other deck K13.

Checkpoints and supervision (dft/scf.py with io/checkpoint.py and
dft/recovery.py): K16a / K16b (the density's coarse box and its scatter
onto the fine G set, kernels/density_scatter.py) and K18 (the H
preconditioner's elementwise pass, kernels/h_diag.py) are held bit for bit
to their plain versions at the 16-atom US shapes (records) and at their
edges (density_hdiag_edges: 1, 2 and 4 channels, a fine set larger than
the coarse sphere, no projectors, a fully masked row, v0 as a float);
every SCF path must launch all three. recovery_fused runs the 2-atom US
deck (fused) unperturbed (the supervisor's snapshot reads and host syncs
an iteration), with a NaN density at iteration 3 (one rollback,
device_nonfinite, 1e-8 Ha of the unperturbed run), at 4, 7 and 10 (the
ladder flush_history, halve_beta_linear, disable_device_scf, converged)
and with a device.oom fault (the OOM ladder's disable_device_scf,
converged), and on the host loop with a NaN density at iteration 3 (the
rollback from its device snapshot). checkpoint_resume_us runs full_width_us's cell with
autosave_every 5, killed after the iteration-5 autosave, resumed through
run_scf(resume=find_resumable(...)) to full_width_us's count within 1e-10
Ha of that run (bit for bit or not is printed), with the file's bytes and
the save, load and fetch_state seconds; then resumes the same file through
run_scf_from_file's ground_state_restart from a JSON deck, which must
write a loadable sirius.h5. fused_ab_us also counts host syncs with the
supervisor off.

The potential's pointwise passes (dft/potential.py::generate_potential,
csrc/potential_passes.cu): K17a (the XC inputs: rho + rho_core, the
clamps, |m| clipped to rho_xc, the spin split), K17b (exc, V_xc and B_z,
also as complex boxes for the FFT), K17c (i) (V_H and the V_eff sum) and
(ii) (GGA's gradient rows), K17d (the coarse boxes through one table, and
the per-spin coarse potential) are held bit for bit to their plain
versions at their edges (potential_edges: NaN, +-inf and -0.0 in every
input, rho under each clamp, |m| over rho_xc, glen2 at and around 1e-12,
odd box and G counts, 1-4 coarse fields, float64 views off a 16-byte
boundary, with and without a core charge) and at the 16-atom US shapes
(records: unpolarized X + PZ inputs, "<pass>.unpolarized", and polarized
PBE ones, "<pass>") and the 54-atom PBE FM ones ("<pass>.54"); every
collinear deck must launch K17a, K17b, K17c (i) and K17d, a polarized GGA
or SCAN deck K17c (ii) too, and a non-collinear deck K17c (i) and K17d's
fill (V, B_x, B_y, B_z). Their rows
in the kernels summary take the 16-atom unpolarized records with
full_width_us's launches and the 54-atom records with
full_width_gamma_pbe_fm's.

Every SCF phase sets the launch counts to 0 just before its run and reads
them just after, and fails if a kernel of its path was not launched (an
unpolarized X + PZ deck must launch K7's zeta = 0 kernel, a non-collinear
LDA deck its polarized X + PZ kernel, an X + PW92 or X + VWN5 deck its own
K7b instantiation). The
kernels summary takes each kernel's launches from the full-width run of its
path: full_width_us for K1-K7, full_width_gamma_us for K7 at 144^3
(lda_xc.pz.unpolarized), K8a, K8b, K1c real
and K2 float64, full_width_chunked_us for K9, full_width_gamma_pbe_fm for
K7g (PBE), K10a, K10b and K6 on axial fields, full_width_scan_us for K7s
unpolarized, K11a and K11b, full_width_spinor_us for K12a, K12b, K6v and
K4 on four channels, full_width_gamma_us and full_width_gamma_pbe_fm for
K4's 54-atom rows on one and two channels, full_width_forces_us's stress
for K4 on strained tables; K7b's X + PW92 and X + VWN5
rows, K7g's unpolarized PBE and PBEsol rows and K7s's polarized row take
theirs from the parity decks that run them (parity_scf_pw_us_afm,
parity_scf_gamma_nc_vwn, parity_scf_pbe_us, parity_scf_gamma_nc_pbesol,
parity_scf_scan_us_fm); polarized X + PZ (lda_xc.pz, at 96^3) from
full_width_spinor_us; the fp32 rows from the run FP32_SUMMARY names.
K7, K7g and K7s count each instantiation apart, so a row's launches are
those of its own instantiation, named in the row; the runtime-mask
instantiations, which no deck runs, have records and no row. Each full-width record counts the run's eigh
calls by the type and order of the matrix (eigh_calls).

The last three lines are the kernels summary, the nvidia-smi name/power
line and {"ok": true, "device": {...}}. Any failure exits non-zero before
the ok line; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory, and fp64 and fp32
# outside the tensor cores, the rates of these kernels' elementwise work;
# fp64 in the tensor cores, the rate of work shaped as a matrix product
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12
FP32_FLOPS_PER_S = 67e12
FP64_TENSOR_FLOPS_PER_S = 67e12

TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
PARITY = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2))
FULL = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2), supercell=2)
GAMMA2 = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(1, 1, 1))
GAMMA54 = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(1, 1, 1), supercell=3)
NC = dict(ultrasoft=False, use_symmetry=False)
US_SYM = dict(ultrasoft=True, use_symmetry=True)
FULL_ITERS = {"full_width": 3, "full_width_us": 6, "full_width_gamma_us": 4,
              "full_width_chunked_us": 4}
RUN_TO_END = {"density_tol": 0.0, "energy_tol": 0.0}
# the 2-atom single-k parity decks: species, SCF parameters (gamma_nc runs
# a fixed 24 iterations, see tools/torch_port_reference.py), control
SINGLE_K = {
    "gamma_nc": (NC, {"num_dft_iter": 24, **RUN_TO_END}, {}),
    "gamma_us_sym": (US_SYM, TIGHT, {}),
    "chunked_us_sym": (US_SYM, TIGHT,
                       {"beta_chunked": True, "beta_chunk_size": 1}),
}
CHUNK54 = 16
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
SPIN = {"num_mag_dims": 1}
FM = [[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]]
AFM = [[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]
# the 2-atom decks of other functionals and collinear spin (the same decks
# as tools/torch_port_reference.py): shape, species, SCF parameters,
# starting moments
XC_DECKS = {
    "pbe_us_sym": (PARITY, US_SYM, dict(TIGHT, xc_functionals=PBE), None),
    "pw_us_sym_afm": (PARITY, US_SYM,
                      dict(TIGHT, xc_functionals=["XC_LDA_X", "XC_LDA_C_PW"],
                           **SPIN), AFM),
    "gamma_pbe_us_sym_fm": (GAMMA2, US_SYM,
                            dict(TIGHT, xc_functionals=PBE, **SPIN), FM),
    "gamma_nc_vwn": (GAMMA2, NC,
                     {"num_dft_iter": 24, **RUN_TO_END,
                      "xc_functionals": ["XC_LDA_X", "XC_LDA_C_VWN"]}, None),
    "gamma_nc_pbesol": (GAMMA2, NC,
                        {"num_dft_iter": 24, **RUN_TO_END,
                         "xc_functionals": ["XC_GGA_X_PBE_SOL",
                                            "XC_GGA_C_PBE_SOL"]}, None),
}
FULL_ITERS["full_width_gamma_pbe_fm"] = 4
# the SCAN meta-GGA decks (the k-set path with the tau operator): the
# 2-atom parity decks of tools/torch_port_reference.py at fixed iteration
# counts, 5 each (their trajectories to a tolerance are not reproducible
# even in the JAX package, and a converged SCAN SCF run on hops between
# states ~1e-8 Ha apart, see that tool); and the 16-atom ultrasoft cell
# with its 384 ops at 3 k-points
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
FIXED_5 = {"num_dft_iter": 5, **RUN_TO_END}
XC_DECKS["scan_us_sym"] = (PARITY, US_SYM, dict(FIXED_5, xc_functionals=SCAN),
                           None)
XC_DECKS["scan_us_sym_fm"] = (PARITY, US_SYM,
                              dict(FIXED_5, xc_functionals=SCAN, **SPIN), FM)
FULL_ITERS["full_width_scan_us"] = 4
# the non-collinear decks (num_mag_dims 3, the spinor k-set solve) are
# those of tools/torch_port_reference.py (SPINOR_DECKS there, built by
# deck_context); the full-width one takes their canted moment
NONCOLLINEAR = {"num_mag_dims": 3}
CANTED = [[0.3, 0.3, 0.3], [0.3, 0.3, 0.3]]
# the 16-atom ultrasoft cell with (0.3, 0.3, 0.3) on every atom: 48
# magnetic ops, 4 k-points (time reversal off), 84 spinor bands
FULL_ITERS["full_width_spinor_us"] = 4
X_PZ = ["XC_LDA_X", "XC_LDA_C_PZ"]
# unpolarized X + PZ launches its own kernel, the closed form at zeta = 0
PZ0 = "lda_xc.pz.unpolarized"
# forces and stress (control.print_forces and print_stress): the recorded
# force decks of tools/torch_port_reference.py (FORCES_DECKS there, built by
# deck_context), each force component within FORCE_TOL Ha/bohr and each
# stress component within STRESS_TOL Ha/bohr^3 of the record, well inside
# the 1e-5 of the JAX package's test_against (sirius_tpu/dft/scf.py:2571);
# and full_width_forces_us: the 16-atom ultrasoft cell with atom 0 moved
# by FORCE_SHIFT (fractional), run to FORCE_SCF's tolerances, F[0, 0] held
# to the central difference of the free energy at +-FORCE_FD_H bohr along
# Cartesian x within FORCE_FD_TOL (tests/test_forces.py's bound), the net
# force to NET_FORCE_TOL
FORCE_TOL = 1e-6
STRESS_TOL = 1e-7
FORCE_FD_H = 2e-3
FORCE_FD_TOL = 5e-5
NET_FORCE_TOL = 1e-5
FORCE_SHIFT = (0.01, 0.0, 0.0)
FORCE_SCF = {"num_dft_iter": 60, "energy_tol": 1e-10, "density_tol": 1e-9}
# the strain of the K4 record on strained Q(G) tables (eps_xy = eps_yx)
STRAIN_XY = 1e-5
# the XC kernel checks: functionals, polarized
XC_CHECKS = {
    "lda_xc.pz": (X_PZ, True),
    PZ0: (X_PZ, False),
    "lda_xc.pw92": (["XC_LDA_X", "XC_LDA_C_PW"], True),
    "lda_xc.pw92.unpolarized": (["XC_LDA_X", "XC_LDA_C_PW"], False),
    "lda_xc.vwn": (["XC_LDA_X", "XC_LDA_C_VWN"], True),
    "lda_xc.vwn.unpolarized": (["XC_LDA_X", "XC_LDA_C_VWN"], False),
    "gga_xc.pbe": (PBE, True),
    "gga_xc.pbe.unpolarized": (PBE, False),
    "gga_xc.pbesol": (["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"], True),
    "gga_xc.pbesol.unpolarized": (["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"],
                                  False),
    "mgga_xc.scan": (SCAN, True),
    "mgga_xc.scan.unpolarized": (SCAN, False),
    # the runtime-mask instantiations, which serve every list that is not
    # a compiled set
    "lda_xc.mask": (["XC_LDA_X"], True),
    "lda_xc.mask.unpolarized": (["XC_LDA_X"], False),
    "gga_xc.mask": (["XC_GGA_X_PBE", "XC_LDA_C_PW"], True),
    "gga_xc.mask.unpolarized": (["XC_GGA_X_PBE", "XC_LDA_C_PW"], False),
    "mgga_xc.mask": (["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"], True),
    "mgga_xc.mask.unpolarized": (["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"], False),
}
# relative tolerance of each kernel against its plain version on the card:
# K1/K2 are a store/gather and three fixed-order row sums (rounding only);
# K3 sums |psi|^2 over bands and K7 evaluates pow/cbrt/log in closed form
# against autograd of the same expression, a few ulp more
# K1c multiplies (rounding only); K4/K5 sum over atoms, pairs and G with
# sincospi phases against dense exp() phases; K6 sums the ops in the same
# order as its plain version, phases again sincospi against exp()
# K8a/K8b/K1c real are stores, gathers and products in the plain version's
# order (rounding only); K2 float64 as K2; K9 evaluates sincospi phases
# against exp() of the rounded angle. K7b and K7g take the derivatives on
# dual numbers against autograd of the same expressions (a different order
# of the chain rule's products, a few ulp), normwise over the box; K10a and
# K10b are products and sums in the plain version's order (rounding only).
# K7, K7b, K7g and K7s, each instantiation, are held to 1e-12 (the compiled
# sets take powers from cbrt and sqrt, a few ulp from pow; the LDA forms
# land within a few 1e-15 of their plain versions); K11a / K11b are a
# store and a gather with products and sums in the plain version's order
# (rounding only)
TOL = {**{name: 1e-12 for name in XC_CHECKS},
       "mgga_tau.grad_to_box": 1e-14, "mgga_tau.box_to_pw_tau": 1e-14,
       "xc_gradient.gradient_boxes": 1e-12,
       "xc_gradient.divergence_pw": 1e-12, "symmetrize_pw.axial": 1e-13,"local_hpsi.pw_to_box": 1e-12, "local_hpsi.box_to_pw_hpsi": 1e-12,
       "davidson_residual": 1e-12, "density_accumulate": 1e-11,
       "lda_xc": 1e-12, "veff_multiply": 1e-12,
       "augmentation.rho_aug": 1e-12, "augmentation.d_operator": 1e-12,
       "symmetrize_pw": 1e-13, "gamma_pack.unpack_to_box": 1e-12,
       "gamma_pack.box_to_packed_hx": 1e-12, "veff_multiply.real": 1e-12,
       "davidson_residual.f64": 1e-12, "beta_chunk": 1e-12,
       # K12a multiplies and adds per point (the compiler's fused
       # multiply-adds against torch's complex products), K12b sums the
       # bands in order as K3, K6v sums the ops in the plain version's order
       # (sincospi against exp() phases), K4 on four channels as on two
       "spinor_veff": 1e-13, "density_accumulate_nc": 1e-13,
       "symmetrize_vector_pw": 1e-13, "augmentation.rho_aug.4": 1e-12,
       "augmentation.d_operator.4": 1e-12,
       # K4 at the 54-atom cell, on one channel and on two
       "augmentation.rho_aug.54": 1e-12, "augmentation.rho_aug.2.54": 1e-12,
       # K4 on one strained table set of the stress against the host
       # rho_aug_g copy (dense exp() phases, einsum)
       "augmentation.rho_aug.strained": 1e-12,
       # K13 sums the count in a fixed block order against torch.sum
       # (occupations and entropy: rounding; mu held to 1e-12 Ha apart);
       # K14a sums per block in tile order against einsum; K14b solves by
       # Jacobi against cuSOLVER's eigh (the random systems are well
       # conditioned); K15 sums each segment in a fixed tree against torch
       "fermi": 1e-12, "mixer.gram": 1e-12, "mixer.update": 1e-12,
       "scf_record": 1e-12,
       # K16a multiplies by 1 / Omega as PyTorch does, K16b and K18 copy
       # and add in the plain version's order: bit for bit (bits_equal is
       # checked as well)
       "density_scatter.coarse_box": 0.0,
       "density_scatter.scatter_fine": 0.0, "h_diag": 0.0}
# K17, the potential's pointwise passes (csrc/potential_passes.cu), each
# pass and the JAX line it replaces; records at the 16-atom US cell,
# polarized PBE inputs (the pass's name) and unpolarized X + PZ ones
# (".unpolarized"), and at the 54-atom PBE FM cell (".54"); bit for bit
K17_REPLACES = {
    "potential_passes.xc_inputs": "sirius_tpu/dft/potential.py:301",
    "potential_passes.xc_outputs": "sirius_tpu/dft/potential.py:329",
    "potential_passes.hartree_veff": "sirius_tpu/dft/poisson.py:21",
    "potential_passes.gga_inputs": "sirius_tpu/dft/potential.py:306",
    "potential_passes.coarse_fill": "sirius_tpu/dft/potential.py:358",
    "potential_passes.coarse_stack": "sirius_tpu/dft/potential.py:363",
}
K17_UNPOLARIZED = tuple(k for k in K17_REPLACES if not k.endswith("gga_inputs"))
K17_NAMES = (tuple(K17_REPLACES) + tuple(k + ".unpolarized"
                                         for k in K17_UNPOLARIZED)
             + tuple(k + ".54" for k in K17_REPLACES))


def k17_base(name: str) -> str:
    """The pass of a K17 record's name (its suffix dropped)."""
    return ".".join(name.split(".")[:2])


TOL.update({name: 0.0 for name in K17_NAMES})
SOURCE = {
    "local_hpsi.pw_to_box": "sirius_tpu_torch/csrc/local_hpsi.cu",
    "local_hpsi.box_to_pw_hpsi": "sirius_tpu_torch/csrc/local_hpsi.cu",
    "davidson_residual": "sirius_tpu_torch/csrc/davidson_residual.cu",
    "density_accumulate": "sirius_tpu_torch/csrc/density_accumulate.cu",
    "lda_xc": "sirius_tpu_torch/csrc/lda_xc.cu",
    "veff_multiply": "sirius_tpu_torch/csrc/veff_multiply.cu",
    "augmentation.rho_aug": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.d_operator": "sirius_tpu_torch/csrc/augmentation.cu",
    "symmetrize_pw": "sirius_tpu_torch/csrc/symmetrize_pw.cu",
    "gamma_pack.unpack_to_box": "sirius_tpu_torch/csrc/gamma_pack.cu",
    "gamma_pack.box_to_packed_hx": "sirius_tpu_torch/csrc/gamma_pack.cu",
    "veff_multiply.real": "sirius_tpu_torch/csrc/veff_multiply.cu",
    "davidson_residual.f64": "sirius_tpu_torch/csrc/davidson_residual.cu",
    "beta_chunk": "sirius_tpu_torch/csrc/beta_chunk.cu",
    **{name: f"sirius_tpu_torch/csrc/{name.split('.')[0]}.cu"
       for name in XC_CHECKS},
    "xc_gradient.gradient_boxes": "sirius_tpu_torch/csrc/xc_gradient.cu",
    "xc_gradient.divergence_pw": "sirius_tpu_torch/csrc/xc_gradient.cu",
    "symmetrize_pw.axial": "sirius_tpu_torch/csrc/symmetrize_pw.cu",
    "mgga_tau.grad_to_box": "sirius_tpu_torch/csrc/mgga_tau.cu",
    "mgga_tau.box_to_pw_tau": "sirius_tpu_torch/csrc/mgga_tau.cu",
    "spinor_veff": "sirius_tpu_torch/csrc/spinor_veff.cu",
    "density_accumulate_nc": "sirius_tpu_torch/csrc/density_accumulate.cu",
    "symmetrize_vector_pw": "sirius_tpu_torch/csrc/symmetrize_pw.cu",
    "augmentation.rho_aug.4": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.d_operator.4": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.rho_aug.54": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.rho_aug.2.54": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.rho_aug.strained": "sirius_tpu_torch/csrc/augmentation.cu",
    "fermi": "sirius_tpu_torch/csrc/fermi.cu",
    "mixer.gram": "sirius_tpu_torch/csrc/mixer.cu",
    "mixer.update": "sirius_tpu_torch/csrc/mixer.cu",
    "scf_record": "sirius_tpu_torch/csrc/scf_record.cu",
    "density_scatter.coarse_box": "sirius_tpu_torch/csrc/density_scatter.cu",
    "density_scatter.scatter_fine":
        "sirius_tpu_torch/csrc/density_scatter.cu",
    "h_diag": "sirius_tpu_torch/csrc/h_diag.cu",
    **{name: "sirius_tpu_torch/csrc/potential_passes.cu"
       for name in K17_NAMES},
}
REPLACES = {
    "local_hpsi.pw_to_box": "sirius_tpu/ops/hamiltonian.py:76",
    "local_hpsi.box_to_pw_hpsi": "sirius_tpu/ops/hamiltonian.py:78",
    "davidson_residual": "sirius_tpu/solvers/davidson.py:141",
    "density_accumulate": "sirius_tpu/parallel/batched.py:343",
    "lda_xc": "sirius_tpu/dft/xc.py:341",
    "veff_multiply": "sirius_tpu/ops/hamiltonian.py:81",
    "augmentation.rho_aug": "sirius_tpu/ops/augmentation.py:250",
    "augmentation.d_operator": "sirius_tpu/ops/augmentation.py:266",
    "symmetrize_pw": "sirius_tpu/dft/density.py:348",
    "gamma_pack.unpack_to_box": "sirius_tpu/ops/gamma.py:222",
    "gamma_pack.box_to_packed_hx": "sirius_tpu/ops/gamma.py:236",
    "veff_multiply.real": "sirius_tpu/ops/gamma.py:230",
    "davidson_residual.f64": "sirius_tpu/ops/gamma.py:277",
    "beta_chunk": "sirius_tpu/ops/beta_chunked.py:295",
    **{name: "sirius_tpu/dft/xc.py:341" for name in XC_CHECKS},
    "xc_gradient.gradient_boxes": "sirius_tpu/dft/potential.py:282",
    "xc_gradient.divergence_pw": "sirius_tpu/dft/potential.py:285",
    "symmetrize_pw.axial": "sirius_tpu/dft/density.py:348",
    "mgga_tau.grad_to_box": "sirius_tpu/ops/mgga.py:44",
    "mgga_tau.box_to_pw_tau": "sirius_tpu/ops/mgga.py:50",
    "spinor_veff": "sirius_tpu/ops/spinor.py:64",
    "density_accumulate_nc": "sirius_tpu/parallel/batched_nc.py:146",
    "symmetrize_vector_pw": "sirius_tpu/dft/potential_nc.py:60",
    "augmentation.rho_aug.4": "sirius_tpu/ops/augmentation.py:250",
    "augmentation.d_operator.4": "sirius_tpu/ops/augmentation.py:266",
    "augmentation.rho_aug.54": "sirius_tpu/ops/augmentation.py:250",
    "augmentation.rho_aug.2.54": "sirius_tpu/ops/augmentation.py:250",
    # the strained augmentation charge of the stress, which the JAX package
    # assembles through the host rho_aug_g
    "augmentation.rho_aug.strained": "sirius_tpu/dft/stress.py:133",
    "fermi": "sirius_tpu/dft/occupation.py:69",
    "mixer.gram": "sirius_tpu/dft/mixer.py:348",
    "mixer.update": "sirius_tpu/dft/mixer.py:381",
    "scf_record": "sirius_tpu/dft/fused.py:400",
    "density_scatter.coarse_box": "sirius_tpu/dft/fused.py:311",
    "density_scatter.scatter_fine": "sirius_tpu/dft/fused.py:316",
    "h_diag": "sirius_tpu/parallel/batched.py:102",
    **{name: K17_REPLACES[k17_base(name)] for name in K17_NAMES},
}
# the fp32 instantiations (precision_wf "fp32"): each kernel's name with the
# suffix of the block type it takes (.c64 complex64, .f32 float32 packed
# blocks), held to its plain version at 1e-5 relative (fp32 rounding; the
# JAX package's own fp32 run moves an energy term by 2.5e-5 Ha), bound by
# 8-byte complex64 and 4-byte float32 elements against fp32 operations, and
# the run its launches come from: the full-width fp32 runs, and for K9 and
# K11 the parity decks of the paths that launch them
FP32_SUMMARY = {
    "local_hpsi.pw_to_box.c64": "full_width_us_fp32",
    "local_hpsi.box_to_pw_hpsi.c64": "full_width_us_fp32",
    "veff_multiply.c64": "full_width_us_fp32",
    "davidson_residual.c64": "full_width_us_fp32",
    "density_accumulate.c64": "full_width_us_fp32",
    "gamma_pack.unpack_to_box.f32": "full_width_gamma_us_fp32",
    "veff_multiply.real.c64": "full_width_gamma_us_fp32",
    "gamma_pack.box_to_packed_hx.f32": "full_width_gamma_us_fp32",
    "davidson_residual.f32": "full_width_gamma_us_fp32",
    "beta_chunk.c64": "chunked_us_sym_fp32",
    "mgga_tau.grad_to_box.c64": "scan_us_sym_fp32",
    "mgga_tau.box_to_pw_tau.c64": "scan_us_sym_fp32",
    "spinor_veff.c64": "full_width_spinor_us_fp32",
    "density_accumulate_nc.c64": "full_width_spinor_us_fp32",
}
FP32_SUFFIXES = (".c64", ".f32")


def base_name(name: str) -> str:
    """The fp64 kernel of an fp32 instantiation's name (itself for an fp64
    one)."""
    return name.rsplit(".", 1)[0] if name.endswith(FP32_SUFFIXES) else name


TOL.update({name: 1e-5 for name in FP32_SUMMARY})
SOURCE.update({name: SOURCE[base_name(name)] for name in FP32_SUMMARY})
REPLACES.update({name: REPLACES[base_name(name)] for name in FP32_SUMMARY})
# the kernels summary: the rows of K7 at 144^3, K7b and K7g (a record at the
# 54-atom box, in the mode its deck runs) and the run their launches come
# from; polarized X + PZ's row (a record at the 16-atom box, 96^3) in
# SUMMARY_XC96
SUMMARY_XC = {PZ0: "full_width_gamma_us",
              "lda_xc.pw92": "pw_us_sym_afm",
              "lda_xc.vwn.unpolarized": "gamma_nc_vwn",
              "gga_xc.pbe": "full_width_gamma_pbe_fm",
              "gga_xc.pbe.unpolarized": "pbe_us_sym",
              "gga_xc.pbesol.unpolarized": "gamma_nc_pbesol"}
SUMMARY_XC96 = {"lda_xc.pz": "full_width_spinor_us"}
# the SCAN rows (records at the 16-atom boxes: fine 96^3 for K7s, coarse
# for K11) and the run their launches come from
SUMMARY_MGGA = {"mgga_xc.scan": "scan_us_sym_fm",
                "mgga_xc.scan.unpolarized": "full_width_scan_us",
                "mgga_tau.grad_to_box": "full_width_scan_us",
                "mgga_tau.box_to_pw_tau": "full_width_scan_us"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, samples: int = 21, inner: int = 5, warm: int = 3) -> float:
    """Median over samples of the mean time of `inner` back-to-back calls,
    between CUDA events on the current stream."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, dev, names, calls: int = 20):
    """Device time of one call of fn: the time of the kernels whose names
    hold one of names, summed by torch.profiler over `calls` calls after a
    warm-up, divided by calls. None off the card, or where the profiler
    shows no device time (then only the event time stands)."""
    import torch

    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if any(n in e.key for n in names))
    return us / calls / 1e3 if us > 0 else None


def bound(nbytes: float, flops: float, fp32: bool = False,
          tensor_flops: float = 0.0) -> tuple[float, str]:
    """The least time in ms and what sets it: nbytes over the memory rate,
    or flops over the elementwise rate plus tensor_flops (fp64 work shaped
    as a matrix product) over the fp64 tensor-core rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = (flops / (FP32_FLOPS_PER_S if fp32 else FP64_FLOPS_PER_S)
          + tensor_flops / FP64_TENSOR_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bits_equal(a, b) -> bool:
    """Bit for bit: the same float64 (or complex128) values, signs of zero
    and NaN payloads included."""
    import torch

    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def pz0_bitwise(rho) -> bool:
    """Unpolarized X + PZ (on the card its zeta = 0 kernel) against the
    polarized launch at (rho/2, rho/2), the parent kernel's code: e against
    e and v against v_up, bit for bit."""
    from sirius_tpu_torch.kernels import lda_xc as k7

    e, v = k7.lda_xc_unpolarized(rho)
    half = 0.5 * rho
    e_p, vu_p, _ = k7.lda_xc(half, half)
    return bits_equal(e, e_p) and bits_equal(v, vu_p)


def rel_err(a, b) -> tuple[float, float]:
    import torch

    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / scale if scale > 0 else err


def record_kernel(out, deck, gpu, name, kernel_out, plain_out, fn_k, fn_p,
                  fn_lib, nbytes, flops, slow_plain=False, extra=None,
                  tensor_flops=0.0):
    """Compare one kernel with its plain version, time both (and the
    library yardstick), emit the record (with the fields of extra) and
    keep it in out[name]. The bound counts tensor_flops at the fp64
    tensor-core rate (bound)."""
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)
            if a is not None]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ms = time_ms(fn_k)
    # a plain version that loops in Python is timed over fewer samples
    plain_ms = (time_ms(fn_p, samples=5, inner=1, warm=1) if slow_plain
                else time_ms(fn_p))
    lib_ms = time_ms(fn_lib) if fn_lib is not None else None
    b_ms, b_by = bound(nbytes, flops, name.endswith(FP32_SUFFIXES),
                       tensor_flops)
    extra = dict(extra or {})
    # the device time of every kernel and fill one call of fn_k launches,
    # where the record has none of its own
    if "device_ms" not in extra:
        dev = next(a for a in kernel_out if a is not None).device
        extra["device_ms"] = device_ms(fn_k, dev, ("",))
    rec = {"phase": "kernel", "deck": deck, "name": name, "gpu": gpu,
           "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": TOL[name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, **extra}
    if tensor_flops:
        rec["tensor_flops"] = tensor_flops
    emit(rec)
    if not rel <= TOL[name]:
        raise AssertionError(f"{name} at {deck}: rel err {rel} > {TOL[name]}")
    out[name] = rec


def sm_count(dev) -> int:
    """The SM count the launch plans read on the card (an H100's 132 off
    it, for the plans the records print)."""
    from sirius_tpu_torch.kernels import build

    return build.sm_count(dev) if dev.type == "cuda" else 132


def residual_plan(nrows: int, ngk: int, element_bytes: int, dev) -> dict:
    """A K2 record's fields: its cluster size C and launch plan."""
    from sirius_tpu_torch.kernels.davidson_residual import (
        davidson_residual_plan)

    plan = davidson_residual_plan(nrows, ngk, element_bytes, sm_count(dev))
    return {"cluster": plan["cluster"], "plan": plan}


# the device work of a K6 launch in the profiler: the kernel and the
# cudaMemsetAsync of the dead G
K6_DEVICE = ("symmetrize_pw_kernel", "Memset")


def symmetrize_work(tb, live, per_pair: float, ncomp: int = 1):
    """(bytes, operations, record fields) of K6 or K6v (ncomp 3) on the
    tables tb with the live G list live: bytes written to out over every G
    and read of the live G's f, Millers and index once; operations of the
    factorised sum, per_pair a (representative, live G); the group's
    factorisation, and the operations bound of the unfactorised sum (every
    op over every G) beside it."""
    c = tb.cosets
    ng = tb.millers.shape[0]
    nlive = int(live.shape[0])
    return (ncomp * ng * 16 + nlive * (ncomp * 16 + 12 + 4),
            nlive * c.num_reps * per_pair,
            {"num_ops": tb.num_ops, "num_translations": c.num_translations,
             "num_reps": c.num_reps, "num_live": nlive, "num_gvec": ng,
             "bound_ms_unfactorised": bound(0.0,
                                            tb.num_ops * ng * per_pair)[0]})


def random_field_errors(name: str, fn_k, fn_p, shape, dev) -> dict:
    """K6 (any form) against its unfactorised plain version on a seeded
    random field, which unlike a symmetric one is nonzero off the live G:
    the relative error elementwise (over the plain version's largest
    value, as record_kernel) and normwise, and the plain version's largest
    value off the live G, where the kernel writes 0. Raises above the
    kernel's tolerance."""
    import numpy as np
    import torch

    rng = np.random.default_rng(59)
    f = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), device=dev)
    k, p = fn_k(f), fn_p(f)
    _, rel = rel_err(k, p)
    norm = float(torch.linalg.vector_norm(k - p)
                 / torch.linalg.vector_norm(p))
    dead = k == 0
    off_live = float(p[dead].abs().max()) if bool(dead.any()) else 0.0
    if not (rel <= TOL[name] and norm <= TOL[name]):
        raise AssertionError(f"{name} on a random field: rel err {rel}, "
                             f"normwise {norm} > {TOL[name]}")
    return {"random_rel_err": rel, "random_norm_rel_err": norm,
            "random_plain_max_off_live": off_live}


def check_d_operator(out, deck: str, gpu: str, name: str, aug: dict, v, dion,
                     omega: float, dev) -> None:
    """K5 on the nch channels of v [nch, ng] for one type's tables against
    its plain version; launched twice on the same inputs, which must give D
    bit for bit; the device time of its two launches (torch.profiler)
    beside the event time, which also holds the wrapper's host time.
    Yardstick: one einsum over the channels, the phases built outside the
    timing."""
    import torch

    from sirius_tpu_torch.kernels import augmentation as k45

    nch, ng = v.shape
    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    nbeta = dion.shape[-1]
    dargs = (aug["millers"], aug["pos"], aug["q"], aug["gidx"], aug["lo_idx"],
             aug["lo_mask"], omega)
    # the bare D of every channel ([nbeta, nbeta]) or per channel
    d0 = dion.expand(nch, nbeta, nbeta).contiguous()
    d_k = k45.d_operator(v, *dargs, d0.clone())
    if not torch.equal(d_k, k45.d_operator(v, *dargs, d0.clone())):
        raise AssertionError(f"{name} at {deck}: two launches on the same "
                             "inputs differ")
    d_t = d0.clone()
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    plan = k45.d_operator_plan(na, nqlm, nch, ng, sm_count(dev))
    record_kernel(out, deck, gpu, name, [d_k],
                  [k45.d_operator_plain(v, *dargs, d0.clone())],
                  lambda: k45.d_operator(v, *dargs, d_t),
                  lambda: k45.d_operator_plain(v, *dargs, d_t),
                  lambda: torch.einsum("qg,cg,ga->caq", aug["q"], v.conj(), ph),
                  nbytes=nqlm * ng * 16 + nch * ng * 16 + ng * 12
                  + 2 * nch * nbeta * nbeta * 8,
                  flops=ng * na * (7.0 + nch * (6.0 + nqlm * 4.0)),
                  extra={"channels": nch, "atoms": na, "num_gvec": ng,
                         "device_ms": device_ms(
                             lambda: k45.d_operator(v, *dargs, d_t), dev,
                             ("d_operator_",)),
                         "plan": plan, "repeat_bitwise": True})


def check_rho_aug(out, deck: str, gpu: str, name: str, aug: dict, ns: int,
                  nbeta: int, rng, dev) -> None:
    """K4 on ns channels of a seeded Hermitian density matrix for one
    type's tables against its plain version, on the tables' (G, -G) rows;
    the record carries K4's plan and the phase check of those rows (the
    count of (G, atom) arguments whose -G phase is not the conjugate of
    G's, bit for bit; raises if one differs by more than a zero's sign).
    Yardstick: K4's einsum, the phases and packed blocks built outside the
    timing. Bound: Q and the Millers read and out written once; a phase (7
    operations) and the atom sum (4 ns nqlm a (row, atom), the product of
    [nrow, na] phases and [na, ns nqlm] coefficients, at the fp64
    tensor-core rate) once a (G, -G) row, as -G's sum is the conjugate of
    G's; the contraction with Q (8 ns nqlm) for every G."""
    import torch

    from sirius_tpu_torch.kernels import augmentation as k45

    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    ng = aug["millers"].shape[0]
    a = (rng.standard_normal((ns, nbeta, nbeta))
         + 1j * rng.standard_normal((ns, nbeta, nbeta)))
    dm = torch.as_tensor((a + a.conj().transpose(0, 2, 1)) * 0.05, device=dev)
    pairs = aug["pairs"]
    nrow = pairs.shape[0]
    targs = (aug["gidx"], aug["w"], aug["millers"], aug["pos"], aug["q"])
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    dmp = (aug["w"][None, None, :]
           * dm.reshape(ns, -1)[:, aug["gidx"].long()].real
           ).to(torch.complex128)
    extra = {"channels": ns, "atoms": na, "num_gvec": ng,
             "rows": nrow, "plan": k45.rho_aug_plan(na, nqlm, ns, nrow)}
    if dev.type == "cuda":
        check = k45.phase_check(aug["millers"], aug["pos"], pairs)
        extra["phase_check"] = check
        if check["argument_differs"] or check["sin_differs"] \
                or check["cos_differs"]:
            raise AssertionError(f"{name} at {deck}: the phase of -G is not "
                                 f"the conjugate of G's: {check}")
    record_kernel(out, deck, gpu, name,
                  [k45.rho_aug(dm, *targs, pairs=pairs)],
                  [k45.rho_aug_plain(dm, *targs)],
                  lambda: k45.rho_aug(dm, *targs, pairs=pairs),
                  lambda: k45.rho_aug_plain(dm, *targs),
                  lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, aug["q"]),
                  nbytes=nqlm * ng * 16 + ns * ng * 16 + ng * 12
                  + ns * nbeta * nbeta * 16,
                  flops=nrow * na * 7.0 + ng * ns * nqlm * 8.0,
                  tensor_flops=nrow * na * ns * nqlm * 4.0, extra=extra)


# K1c's edge shapes: (case, row length, view offset in elements); an odd
# row length puts every other complex64 row 8 bytes off a 16-byte boundary,
# a one-element offset all of them (a complex128 element stays aligned)
K1C_EDGES = (("odd n", 27 ** 3, 0), ("offset view", 30 ** 3, 1),
             ("odd n, offset view", 27 ** 3, 1))


def synthetic_aug_tables(rng, na: int, ng: int, dev, nproj: int = 4,
                         symmetric: bool = False,
                         g0_last: bool = False) -> dict:
    """One type's K4 / K5 tables of random values: na atoms of nproj
    projectors (nqlm = nproj (nproj + 1) / 2 packed pairs), Millers in
    [-15, 15], the pair indices of ops/augmentation.py::
    build_aug_device_tables. symmetric: ng (odd) distinct Millers closed
    under G -> -G with G = 0 among them (last with g0_last), as K4's
    (G, -G) rows need."""
    import numpy as np
    import torch

    xi1, xi2 = np.triu_indices(nproj)
    nbeta = nproj * na
    off = nproj * np.arange(na)[:, None]
    gidx = (off + xi1) * nbeta + off + xi2
    lo_idx = (off + xi2) * nbeta + off + xi1

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    nqlm = len(xi1)
    q = rng.standard_normal((nqlm, ng)) + 1j * rng.standard_normal((nqlm, ng))
    if symmetric:
        # one of each (G, -G): the triples whose first nonzero entry is
        # positive, (ng - 1) / 2 of them, their negations, then G = 0
        box = np.stack(np.meshgrid(*[np.arange(-15, 16)] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
        lead = box[np.arange(len(box)), np.argmax(box != 0, axis=1)]
        half = box[lead > 0]
        half = half[rng.choice(len(half), (ng - 1) // 2, replace=False)]
        millers = rng.permutation(np.concatenate([half, -half]))
        at = len(millers) if g0_last else int(rng.integers(0, ng))
        millers = np.insert(millers, at, 0, axis=0)
    else:
        millers = rng.integers(-15, 16, (ng, 3))
    return {"millers": t(millers, torch.int32),
            "pos": t(rng.uniform(0.0, 1.0, (na, 3)), torch.float64),
            "q": t(q, torch.complex128), "w": t(np.where(xi1 == xi2, 1.0, 2.0),
                                                torch.float64),
            "gidx": t(gidx, torch.int32), "lo_idx": t(lo_idx, torch.int32),
            "lo_mask": t(xi1 != xi2, torch.float64), "nbeta": nbeta}


def synthetic_pack_tables(rng, rows: int, npair: int, npad: int, nbox: int,
                          real, dev):
    """K8b's inputs on random tables: (vbox [1, rows, nbox], x [1, rows,
    ngk], (ekin_p, mask_p, rep_box, par_box, zero_box)) at real, with P =
    npair pairs at distinct random box addresses and npad padding slots
    (mask 0) past 1 + 2P, which no deck here has."""
    import numpy as np
    import torch

    ngk = 1 + 2 * npair + npad
    addr = rng.permutation(nbox)[:2 * npair + 1]
    mask = np.r_[np.ones(1 + 2 * npair), np.zeros(npad)]
    tables = (torch.as_tensor(rng.uniform(0.0, 5.0, ngk), device=dev).to(real),
              torch.as_tensor(mask, device=dev).to(real),
              torch.as_tensor(addr[:npair], dtype=torch.int32, device=dev),
              torch.as_tensor(addr[npair:2 * npair], dtype=torch.int32,
                              device=dev),
              int(addr[-1]))
    x = torch.as_tensor(rng.standard_normal((1, rows, ngk)),
                        device=dev).to(real)
    z = torch.as_tensor(rng.standard_normal((2, 1, rows, nbox)), device=dev)
    vbox = torch.complex(z[0], z[1]).to(
        torch.complex128 if real == torch.float64 else torch.complex64)
    return vbox, x, tables


# K8b's edge shapes: (rows, pairs, padding slots, box entries); 129 rows
# end on a half tile, 1 row is less than one tile, 1 + P + npad threads
# leave the last block part empty
K8B_EDGES = ((129, 2999, 7, 8192), (1, 2999, 7, 8192), (129, 2999, 0, 8192))


# K4's edge shapes: (case, atoms, G, projectors); 41 G is 21 rows, below
# one row tile, 10007 G ends off every tile, 54 atoms make the plan take a
# smaller row tile (on one channel, and split q over two threads a row),
# "atom tiles" takes the fewest atoms (growing by half) that one tile of
# shared memory does not hold, 2 and 5 projectors give nqlm 3 (q chunks
# 2 + 1) and 15 (8 + 4 + 2 + 1; split on one channel at 54 atoms: 4 + 2 + 1
# and 8); "G = 0 last" puts G = 0 at the last index, "accumulate" adds into
# a random out
K4_EDGES = (("below one row tile", 7, 41, 4),
            ("off the row tile", 7, 10007, 4), ("one atom", 1, 2001, 4),
            ("tile shrinks", 54, 2001, 4),
            ("atom tiles", 0, 2001, 4), ("nqlm 3", 7, 2001, 2),
            ("nqlm 15", 7, 2001, 5), ("q split, nqlm 15", 54, 2001, 5),
            ("G = 0 last", 7, 2001, 4), ("accumulate", 7, 2001, 4))


def check_rho_aug_edges(dev, gpu: str, rng) -> None:
    """K4 against its plain version at K4_EDGES with 1, 2 and 4 channels, on
    symmetric random G sets through gvec_pairs, each at 1e-12 relative.
    Emits one kernel_edges line a case and channel count, with the plan and
    whether G = 0's row is (g, g)."""
    import torch

    from sirius_tpu_torch.kernels import augmentation as k45

    tol = TOL["augmentation.rho_aug"]
    for ns in (1, 2, 4):
        for case, na, ng, nproj in K4_EDGES:
            if case == "atom tiles":
                na = 8
                while k45.rho_aug_plan(na, 10, ns, ng // 2 + 1)[
                        "atom_tiles"] == 1:
                    na += na // 2
            aug = synthetic_aug_tables(rng, na, ng, dev, nproj=nproj,
                                       symmetric=True,
                                       g0_last=case == "G = 0 last")
            nbeta, nqlm = aug["nbeta"], aug["q"].shape[0]
            a = (rng.standard_normal((ns, nbeta, nbeta))
                 + 1j * rng.standard_normal((ns, nbeta, nbeta)))
            dm = torch.as_tensor((a + a.conj().transpose(0, 2, 1)) * 0.05,
                                 device=dev)
            pairs = k45.gvec_pairs(aug["millers"])
            targs = (aug["gidx"], aug["w"], aug["millers"], aug["pos"],
                     aug["q"])
            want = k45.rho_aug_plain(dm, *targs)
            out = None
            if case == "accumulate":
                base = torch.as_tensor(rng.standard_normal((ns, ng))
                                       + 1j * rng.standard_normal((ns, ng)),
                                       device=dev)
                out, want = base.clone(), base + want
            got = k45.rho_aug(dm, *targs, out=out, pairs=pairs)
            abs_err, rel = rel_err(got, want)
            g0 = int((aug["millers"] == 0).all(1).nonzero()[0, 0])
            g0_rows = pairs[(pairs[:, 0] == g0) | (pairs[:, 1] == g0)]
            plan = k45.rho_aug_plan(na, nqlm, ns, pairs.shape[0])
            emit({"phase": "kernel_edges", "gpu": gpu,
                  "name": "augmentation.rho_aug", "case": case,
                  "channels": ns, "atoms": na, "num_gvec": ng, "nqlm": nqlm,
                  "rows": pairs.shape[0], "g0_index": g0,
                  "g0_row_self": g0_rows.tolist() == [[g0, g0]], "plan": plan,
                  "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": tol})
            if not (rel <= tol and g0_rows.tolist() == [[g0, g0]]):
                raise AssertionError(f"rho_aug ({case}, {ns} channels): rel "
                                     f"err {rel}, G = 0 rows {g0_rows}")


def check_kernel_edges(dev, gpu: str) -> None:
    """K1c, K5 and K8b against their plain versions at the shapes their
    vector paths and launch plans treat apart. K1c, both modes and both
    precisions, [2, 11, n] with ns = 2 (11 rows: not a whole row group) at
    the K1C_EDGES cases, bitwise, the elements around the view untouched.
    K5 at ng = 10007 (no multiple of any tile or chunk) on 7 atoms with 1,
    2 and 4 channels, at ng = 29 (below one tile), and on four channels of
    more atoms than one launch takes, each at 1e-12 relative and
    twice on the same inputs with a bitwise-equal D. K8b, both
    instantiations, at the K8B_EDGES cases, bitwise. Then K10a, K2 and the
    XC kernels at theirs, and K4 at K4_EDGES (check_rho_aug_edges). Emits
    one kernel_edges line a case."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import gamma_pack as k8
    from sirius_tpu_torch.kernels import veff_multiply as k1c

    rng = np.random.default_rng(41)
    b, r, ns = 2, 11, 2
    for fp32 in (False, True):
        real = torch.float32 if fp32 else torch.float64
        for mode in ("", ".real"):
            fn, plain = ((k1c.veff_multiply_real, k1c.veff_multiply_real_plain)
                         if mode else (k1c.veff_multiply,
                                       k1c.veff_multiply_plain))
            name = "veff_multiply" + mode + (".c64" if fp32 else "")
            for case, n, off in K1C_EDGES:
                total = b * r * n
                x = torch.as_tensor(rng.standard_normal((2, total + 2)),
                                    device=dev).to(real)
                buf = torch.complex(x[0], x[1])
                veff = torch.as_tensor(rng.uniform(-1.0, 1.0, ns * n + 1),
                                       device=dev).to(real)[off:off + ns * n]
                want = buf.clone()
                plain(want[off:off + total].view(b, r, n), veff.view(ns, n))
                fr = buf[off:off + total].view(b, r, n)
                fn(fr, veff.view(ns, n))
                bitwise = bool(torch.equal(buf, want))
                emit({"phase": "kernel_edges", "gpu": gpu, "name": name,
                      "case": case, "shape": [b, r, n], "ns": ns,
                      "offset_elements": off,
                      "fr_offset_bytes": fr.data_ptr() % 16,
                      "bitwise": bitwise})
                if not bitwise:
                    raise AssertionError(f"{name} ({case}): not bitwise "
                                         "equal to its plain version")
    sm = sm_count(dev)
    # the fewest atoms (growing by half) that four channels take in more
    # than one launch
    many = 8
    while k45.d_operator_plan(many, 10, 4, 2003, sm)["ngroups"] == 1:
        many += many // 2
    cases = [(1, 7, 10007), (2, 7, 10007), (4, 7, 10007), (1, 3, 29),
             (4, many, 2003)]
    for nch, na, ng in cases:
        aug = synthetic_aug_tables(rng, na, ng, dev)
        nbeta = 4 * na
        a = rng.standard_normal((nbeta, nbeta))
        dion = torch.as_tensor(a + a.T, device=dev)
        v = torch.as_tensor(rng.standard_normal((nch, ng))
                            + 1j * rng.standard_normal((nch, ng)), device=dev)
        dargs = (aug["millers"], aug["pos"], aug["q"], aug["gidx"],
                 aug["lo_idx"], aug["lo_mask"], 0.7)
        d0 = dion.expand(nch, nbeta, nbeta).contiguous()
        d_k = k45.d_operator(v, *dargs, d0.clone())
        repeat = bool(torch.equal(d_k, k45.d_operator(v, *dargs, d0.clone())))
        abs_err, rel = rel_err(d_k, k45.d_operator_plain(v, *dargs, d0.clone()))
        plan = k45.d_operator_plan(na, 10, nch, ng, sm)
        emit({"phase": "kernel_edges", "gpu": gpu,
              "name": "augmentation.d_operator", "channels": nch, "atoms": na,
              "num_gvec": ng, "plan": plan, "max_abs_err": abs_err,
              "max_rel_err": rel, "tol_rel": TOL["augmentation.d_operator"],
              "repeat_bitwise": repeat})
        if not (rel <= TOL["augmentation.d_operator"] and repeat):
            raise AssertionError(f"d_operator at nch {nch}, na {na}, ng {ng}:"
                                 f" rel err {rel}, repeat bitwise {repeat}")
    for real, sfx in ((torch.float64, ""), (torch.float32, ".f32")):
        name = "gamma_pack.box_to_packed_hx" + sfx
        for rows, npair, npad, nbox in K8B_EDGES:
            vbox, x, pargs = synthetic_pack_tables(rng, rows, npair, npad,
                                                   nbox, real, dev)
            got = k8.box_to_packed_hx(vbox, x, *pargs)
            want = k8.box_to_packed_hx_plain(vbox, x, *pargs)
            bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
            emit({"phase": "kernel_edges", "gpu": gpu, "name": name,
                  "rows": rows, "npair": npair, "padding_slots": npad,
                  "nbox": nbox, "plan": k8.pack_plan(rows, x.shape[-1], npair),
                  "bitwise": bitwise})
            if not bitwise:
                raise AssertionError(f"{name} at {rows} rows, {npad} padding "
                                     "slots: not bitwise equal to its plain "
                                     "version")
    check_gradient_edges(dev, gpu, rng)
    check_residual_edges(dev, gpu, rng)
    check_xc_edges(dev, gpu, rng)
    check_rho_aug_edges(dev, gpu, np.random.default_rng(43))


# K10a's edge shapes: (fields, box); 7 x 11 x 13 = 1001 slots, no multiple
# of the kernel's 256-thread block, and a box of 3 slots
K10A_EDGES = ((1, (7, 11, 13)), (2, (7, 11, 13)), (3, (7, 11, 13)),
              (1, (1, 1, 3)))


def check_gradient_edges(dev, gpu: str, rng) -> None:
    """K10a against its plain version at K10A_EDGES, bit for bit: a G set
    of a third of the box's slots (at least one) in random order, the last
    slot among them. Emits one kernel_edges line a case."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import xc_gradient as k10

    for nfield, dims in K10A_EDGES:
        nbox = int(np.prod(dims))
        ng = max(1, nbox // 3)
        slots = rng.choice(nbox - 1, ng - 1, replace=False)
        slots = rng.permutation(np.append(slots, nbox - 1)).astype(np.int32)
        box_to_g = np.full(nbox, -1, dtype=np.int32)
        box_to_g[slots] = np.arange(ng, dtype=np.int32)
        z = rng.standard_normal((2, nfield, ng))
        f = torch.as_tensor(z[0] + 1j * z[1], device=dev)
        gcart = torch.as_tensor(rng.standard_normal((ng, 3)), device=dev)
        fft_index = torch.as_tensor(slots, device=dev)
        got = k10.gradient_boxes(f, gcart, fft_index, nbox,
                                 torch.as_tensor(box_to_g, device=dev))
        bitwise = bits_equal(got, k10.gradient_boxes_plain(f, gcart,
                                                           fft_index, nbox))
        emit({"phase": "kernel_edges", "gpu": gpu,
              "name": "xc_gradient.gradient_boxes", "fields": nfield,
              "dims": list(dims), "nbox": nbox, "num_gvec": ng,
              "last_slot_live": bool(box_to_g[-1] >= 0), "bitwise": bitwise})
        if not bitwise:
            raise AssertionError(f"gradient_boxes at {nfield} fields, box "
                                 f"{dims}: not bitwise equal to its plain "
                                 "version")


# the XC edge cases: name, points (one point; 933, no multiple of the
# 128- or 256-thread block)
XC_EDGES = (("one point", 1), ("off the block", 933), ("all dead", 933),
            ("sigma 0 at zeta +-1", 933), ("fully polarized", 933),
            ("zeta within ulp of +-1", 933), ("n_up == n_dn", 933),
            ("alpha at 1", 933))
# the cases K7's instantiations alone run: at zeta = +-1 with both channels
# live, PBE correlation's phi = ((1 + zeta)^(2/3) + (1 - zeta)^(2/3)) / 2
# has an unbounded slope, and v is not finite in the JAX package either
LDA_ONLY_EDGES = ("zeta within ulp of +-1",)
# unpolarized X + PZ's: its threshold falls at rho = 2 DENS_TH
PZ0_EDGES = (("one point", 1), ("off the block", 933), ("all dead", 933),
             ("at and below 2 DENS_TH", 933))


def xc_edge_fields(case: str, n: int, rng, dev) -> dict:
    """Seeded inputs of one XC edge case: spin densities, their gradients
    and kinetic-energy densities, and the total density, gradient and tau
    of the unpolarized form. "all dead": every channel below DENS_TH;
    "sigma 0 at zeta +-1": one channel exactly 0 on alternate points, zero
    gradients; "fully polarized": the same with gradients; "zeta within
    ulp of +-1": one channel 1e3 to 1e4, the other 1 to 8 DENS_TH (both
    live), so zeta rounds to +-1 or to at most 14 ulp from it; "n_up == n_dn":
    equal channels, rho = n_up + n_dn exactly; "alpha at 1": tau_s =
    tau_W + tau_unif, so SCAN's alpha
    sits at 1 up to rounding, where scan_interp switches branch; "at and
    below 2 DENS_TH": rho alternately 2 DENS_TH and the next float below,
    where each half channel is just live and just dead."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels.xc_functionals import DENS_TH

    rho = np.exp(rng.uniform(np.log(1e-4), np.log(1.0), n))
    frac = rng.uniform(-0.9, 0.9, n)
    grad_scale = rho ** (4.0 / 3.0)
    if case == "all dead":
        rho = rng.choice([0.0, 1e-14, 1.9e-13], n)
        frac = rng.uniform(-0.05, 0.05, n)
    if case in ("sigma 0 at zeta +-1", "fully polarized"):
        frac = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    if case == "sigma 0 at zeta +-1":
        grad_scale = np.zeros(n)
    if case == "n_up == n_dn":
        frac = np.zeros(n)
        # dead, at and just below the threshold of each channel
        edge = [0.0, 1e-14, 2.0 * DENS_TH, np.nextafter(2.0 * DENS_TH, 0.0)]
        rho[:min(n, 4)] = edge[:min(n, 4)]
    if case == "at and below 2 DENS_TH":
        rho = np.where(np.arange(n) % 2 == 0, 2.0 * DENS_TH,
                       np.nextafter(2.0 * DENS_TH, 0.0))
    nu, nd = 0.5 * rho * (1.0 + frac), 0.5 * rho * (1.0 - frac)
    if case == "zeta within ulp of +-1":
        big = 10.0 ** rng.uniform(3.0, 4.0, n)
        small = DENS_TH * rng.uniform(1.0, 8.0, n)
        up = np.arange(n) % 2 == 0
        nu, nd = np.where(up, big, small), np.where(up, small, big)
        rho = nu + nd
        grad_scale = rho ** (4.0 / 3.0)
    gu = rng.standard_normal((3, n)) * grad_scale
    gd = rng.standard_normal((3, n)) * grad_scale
    tau_unif = 0.3 * (6.0 * math.pi**2) ** (2.0 / 3.0)

    def tau(n_s, g):
        w = 1.0 if case == "alpha at 1" else rng.uniform(0.5, 2.0, n)
        return (tau_unif * n_s ** (5.0 / 3.0) * w
                + (g * g).sum(0) / np.maximum(8.0 * n_s, 1e-30))

    tu, td = tau(nu, gu), tau(nd, gd)
    g1 = gu + gd
    tt = (tau_unif / 2.0 ** (2.0 / 3.0) * rho ** (5.0 / 3.0)
          + (g1 * g1).sum(0) / np.maximum(8.0 * rho, 1e-30)
          if case == "alpha at 1" else tu + td)
    return {k: torch.as_tensor(v, device=dev) for k, v in dict(
        nu=nu, nd=nd, gu=gu, gd=gd, tu=tu, td=td, rho=rho, g1=g1,
        tt=tt).items()}


def xc_call(name: str, f: dict, plain: bool = False):
    """The kernel (or its plain version) of an XC_CHECKS name on the fields
    f of xc_edge_fields: polarized on (n_up, n_dn [, gradients [, tau]]),
    unpolarized on (rho [, gradient [, tau]])."""
    from sirius_tpu_torch.kernels import gga_xc as k7g
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import mgga_xc as k7s

    names, pol = XC_CHECKS[name]
    kind = name.split(".")[0]
    mod = {"lda_xc": k7, "gga_xc": k7g, "mgga_xc": k7s}[kind]
    fn = kind + ("" if pol else "_unpolarized") + ("_plain" if plain else "")
    if pol:
        args = ((f["nu"], f["nd"]) + ((f["gu"], f["gd"])
                                      if kind != "lda_xc" else ())
                + ((f["tu"], f["td"]) if kind == "mgga_xc" else ()))
    else:
        args = ((f["rho"],) + ((f["g1"],) if kind != "lda_xc" else ())
                + ((f["tt"],) if kind == "mgga_xc" else ()))
    return getattr(mod, fn)(*args, names)


def check_xc_edges(dev, gpu: str, rng) -> None:
    """Every K7, K7b, K7g and K7s instantiation (the compiled sets and the
    runtime masks, polarized and unpolarized: the names of XC_CHECKS)
    against its plain version at the XC_EDGES cases (LDA_ONLY_EDGES for K7's
    alone), each at its XC_CHECKS tolerance, and at "n_up == n_dn"
    polarized X + PZ bit for bit the zeta = 0 kernel at rho = n_up + n_dn
    (e, and v_up and v_dn against v);
    unpolarized X + PZ at the PZ0_EDGES cases against its plain version and
    bit for bit against the polarized kernel at (rho/2, rho/2). Emits one
    kernel_edges line a case; raises on a miss."""
    from sirius_tpu_torch.kernels import gga_xc as k7g
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import mgga_xc as k7s

    for case, n in PZ0_EDGES:
        rho = xc_edge_fields(case, n, rng, dev)["rho"]
        got = k7.lda_xc_unpolarized(rho)
        errs = [rel_err(a, b) for a, b in
                zip(got, k7.lda_xc_unpolarized_plain(rho))]
        rel = max(e[1] for e in errs)
        bitwise = pz0_bitwise(rho)
        finite = all(bool(a.isfinite().all()) for a in got)
        emit({"phase": "kernel_edges", "gpu": gpu, "name": PZ0, "case": case,
              "points": n, "max_abs_err": max(e[0] for e in errs),
              "max_rel_err": rel, "tol_rel": TOL[PZ0], "finite": finite,
              "bitwise_polarized": bitwise})
        if not (rel <= TOL[PZ0] and finite and bitwise):
            raise AssertionError(f"{PZ0} ({case}): rel err {rel}, finite "
                                 f"{finite}, bitwise polarized {bitwise}")

    for case, n in XC_EDGES:
        f = xc_edge_fields(case, n, rng, dev)
        for name, (names, pol) in XC_CHECKS.items():
            mod = {"lda_xc": k7, "gga_xc": k7g,
                   "mgga_xc": k7s}[name.split(".")[0]]
            if case in LDA_ONLY_EDGES and mod is not k7:
                continue
            got = xc_call(name, f)
            want = xc_call(name, f, plain=True)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            finite = all(bool(a.isfinite().all()) for a in got)
            rel = max(e[1] for e in errs)
            rec = {"phase": "kernel_edges", "gpu": gpu, "name": name,
                   "instantiation": mod.instantiation(names)[0], "case": case,
                   "points": n, "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": rel, "tol_rel": TOL[name], "finite": finite}
            ok = rel <= TOL[name] and finite
            if name == "lda_xc.pz" and case == "n_up == n_dn":
                e0, v0 = k7.lda_xc_unpolarized(f["rho"])
                rec["bitwise_zeta0"] = (bits_equal(got[0], e0)
                                        and bits_equal(got[1], v0)
                                        and bits_equal(got[2], v0))
                ok = ok and rec["bitwise_zeta0"]
            emit(rec)
            if not ok:
                raise AssertionError(f"{name} ({case}): rel err {rel}, "
                                     f"finite {finite}, bitwise zeta = 0 "
                                     f"{rec.get('bitwise_zeta0')}")


# K2's edge shapes: (batches, bands, row bytes over SMALL_ROW_BYTES); rows
# 3 elements longer than a cluster's threshold (odd lengths: slices and w's
# 16-byte vectors start off their boundaries, the last slice is shorter)
# and one element shorter (one block a row)
K2_EDGES = ((3, 14, 3), (1, 129, -1))


def check_residual_edges(dev, gpu: str, rng) -> None:
    """K2's four instantiations against their plain versions at K2_EDGES,
    with and without w, each at its tolerance and twice on the same inputs
    for bitwise-equal results. Row 0 of each batch is an exact eigenpair
    (the converged branch), the mask drops a tenth of the G. Emits one
    kernel_edges line a case."""
    import torch

    from sirius_tpu_torch.kernels import davidson_residual as k2

    sm = sm_count(dev)
    for dtype, sfx in ((torch.complex128, ""), (torch.float64, ".f64"),
                       (torch.complex64, ".c64"), (torch.float32, ".f32")):
        name = "davidson_residual" + sfx
        real = torch.float64 if sfx in ("", ".f64") else torch.float32
        eb = torch.empty((), dtype=dtype).element_size()
        tol = 1e-3 if real == torch.float32 else 1e-6
        for b, nb, extra in K2_EDGES:
            ngk = k2.SMALL_ROW_BYTES // eb + extra

            def block():
                z = torch.as_tensor(rng.standard_normal((2, b, nb, ngk)),
                                    device=dev)
                return (torch.complex(z[0], z[1]) if dtype.is_complex
                        else z[0]).to(dtype)

            # S positive and H x near x's span, as a band solve's blocks:
            # <x|S x> and <x|H x> then sum without cancelling, so the two
            # summation orders agree to the precision's rounding
            x = block()
            sx = x * torch.as_tensor(rng.uniform(1.0, 2.0, (b, nb, ngk)),
                                     device=dev).to(real)
            hx = x * torch.as_tensor(rng.uniform(-1.0, 3.0, (b, nb, ngk)),
                                     device=dev).to(real) + 0.01 * block()
            hx[:, 0] = 2.0 * sx[:, 0]
            hd = torch.as_tensor(rng.uniform(1.0, 3.0, (b, ngk)),
                                 device=dev).to(real)
            od = torch.ones((b, ngk), dtype=real, device=dev)
            mask = torch.as_tensor(rng.uniform(0.0, 1.0, (b, ngk)) > 0.1,
                                   device=dev).to(real)
            for want_w in (True, False):
                args = (x, hx, sx, hd, od, mask, tol, want_w)
                got = k2.davidson_residual(*args)
                again = k2.davidson_residual(*args)
                want = k2.davidson_residual_plain(*args)
                repeat = all(torch.equal(u, v) for u, v in zip(got, again)
                             if u is not None)
                abs_err, rel = (max(e) for e in zip(*(
                    rel_err(u, v) for u, v in zip(got, want)
                    if u is not None)))
                plan = k2.davidson_residual_plan(b * nb, ngk, eb, sm)
                emit({"phase": "kernel_edges", "gpu": gpu, "name": name,
                      "shape": [b, nb, ngk], "want_w": want_w, "plan": plan,
                      "max_abs_err": abs_err, "max_rel_err": rel,
                      "tol_rel": TOL[name], "repeat_bitwise": repeat})
                if not (rel <= TOL[name] and repeat):
                    raise AssertionError(
                        f"{name} at {[b, nb, ngk]}, want_w {want_w}: rel err "
                        f"{rel}, repeat bitwise {repeat}")


def make_context(spec: dict, extra: dict | None = None, kind: dict = NC):
    from sirius_tpu_torch.testing import synthetic_silicon_context

    return synthetic_silicon_context(extra_params=dict(extra or {}), **kind,
                                     **spec)


def element_bytes(fp32: bool) -> tuple[int, int, str]:
    """(bytes of a complex element, of a real one, name suffix) of the fp64
    or the fp32 instantiations."""
    return (8, 4, ".c64") if fp32 else (16, 8, "")


def check_kernels(deck: str, ctx, dev, gpu: str, fp32: bool = False) -> dict:
    """Each kernel against its plain version at this deck's main-path
    shapes; fp32: the complex64 instantiations of K1, K2 and K3 on the fp32
    tables (K7 has none). Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.core.fftgrid import g_to_r
    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import density_accumulate as k3
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import local_hpsi as k1
    from sirius_tpu_torch.ops.hamiltonian import apply_h_s
    from sirius_tpu_torch.parallel.batched import make_hkset_params

    nk, nb, ngk = ctx.gkvec.num_kpoints, ctx.num_bands, ctx.gkvec.ngk_max
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    nfine = int(np.prod(ctx.gvec.fft.dims))
    rng = np.random.default_rng(7)
    cb, rb, sfx = element_bytes(fp32)
    wf = torch.complex64 if fp32 else torch.complex128
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)
    ps = make_hkset_params(ctx, pot.veff_r_coarse.cpu().numpy(), device=dev,
                           dtype=wf)
    hk = ps.hk()
    mask = hk.mask
    psi_np = (rng.standard_normal((nk, nb, ngk))
              + 1j * rng.standard_normal((nk, nb, ngk)))
    # padded lanes hold garbage
    psi = torch.as_tensor(psi_np, device=dev).to(wf)
    idx = hk.fft_index
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)

    # K1a: sphere -> box scatter at the Davidson step shape [nk, nb, ngk]
    box_k = k1.pw_to_box(psi, idx, mask, n)
    box_p = k1.pw_to_box_plain(psi, idx, mask, n)
    valid = (mask > 0)
    bi, gi = torch.nonzero(valid, as_tuple=True)
    rows = (bi[:, None] * nb + torch.arange(nb, device=dev)[None, :]).reshape(-1)
    cols = idx[bi, gi].long().repeat_interleave(nb)
    vals = psi.permute(0, 2, 1)[bi, gi].reshape(-1)

    def lib_scatter():
        z = torch.zeros((nk * nb, n), dtype=wf, device=dev)
        return z.index_put_((rows, cols), vals)

    record("local_hpsi.pw_to_box" + sfx, [box_k], [box_p],
           lambda: k1.pw_to_box(psi, idx, mask, n),
           lambda: k1.pw_to_box_plain(psi, idx, mask, n), lib_scatter,
           nbytes=nk * nb * ngk * cb + nk * ngk * (4 + rb) + nk * nb * n * cb,
           flops=0.0)
    del box_p

    # K1b: box -> sphere gather fused with ekin*psi and the mask
    vbox = torch.fft.fftn(box_k.view((nk, nb) + dims), dim=(-3, -2, -1)).view(nk, nb, n)
    del box_k
    h_k = k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx)
    h_p = k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx)
    gidx = idx.long()[:, None, :].expand(nk, nb, ngk)
    record("local_hpsi.box_to_pw_hpsi" + sfx, list(h_k), list(h_p),
           lambda: k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx),
           lambda: k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx),
           lambda: torch.gather(vbox, 2, gidx),
           nbytes=nk * nb * ngk * 4 * cb + nk * ngk * (4 + 2 * rb),
           flops=nk * nb * ngk * 8.0)
    del vbox, h_k, h_p

    # K2: residual + preconditioner on a real (x, Hx, Sx); row 0 of each
    # k-point is an exact eigenpair so the converged branch is exercised
    x = psi * mask[:, None, :]
    hx, sx = apply_h_s(hk, x)
    hx[:, 0] = 2.0 * sx[:, 0]
    hd = ps.h_diag.reshape(nk, ngk)
    od = ps.o_diag
    # (an fp32 eigenpair row's residual is at fp32 rounding of |H x|)
    tol = 1e-3 if fp32 else 1e-6
    r_k = k2.davidson_residual(x, hx, sx, hd, od, mask, tol)
    r_p = k2.davidson_residual_plain(x, hx, sx, hd, od, mask, tol)
    if not bool((r_k[1][:, 0] < tol).all()):
        raise AssertionError("davidson_residual: eigenpair rows not converged")
    record("davidson_residual" + sfx, list(r_k), list(r_p),
           lambda: k2.davidson_residual(x, hx, sx, hd, od, mask, tol),
           lambda: k2.davidson_residual_plain(x, hx, sx, hd, od, mask, tol),
           None,
           nbytes=nk * nb * ngk * 4 * cb + nk * ngk * 3 * rb + nk * nb * 2 * rb,
           flops=nk * nb * ngk * 30.0,
           extra={**residual_plan(nk * nb, ngk, cb, dev),
                  "device_ms": device_ms(
                      lambda: k2.davidson_residual(x, hx, sx, hd, od, mask,
                                                   tol), dev,
                      ("residual_rows",))})
    del x, hx, sx, r_k, r_p

    # K3: |psi(r)|^2 accumulation of one k-point's box, [1, nb, N]
    box = k1.pw_to_box(psi[:1], idx[:1], mask[:1], n)
    fr = torch.fft.ifftn(box.view((1, nb) + dims), dim=(-3, -2, -1)).view(1, nb, n)
    del box
    occ = torch.as_tensor(rng.uniform(0.0, 0.25, (1, nb)), device=dev)
    acc0 = torch.as_tensor(rng.uniform(0.0, 1.0, (1, n)), device=dev)
    a_k = k3.density_accumulate(acc0.clone(), fr, occ, float(n) ** 2)
    a_p = k3.density_accumulate_plain(acc0.clone(), fr, occ, float(n) ** 2)
    acc_t = acc0.clone()
    record("density_accumulate" + sfx, [a_k], [a_p],
           lambda: k3.density_accumulate(acc_t, fr, occ, float(n) ** 2),
           lambda: k3.density_accumulate_plain(acc_t, fr, occ, float(n) ** 2),
           None, nbytes=nb * n * cb + n * 16 + nb * 8, flops=nb * n * 4.0)
    del fr
    if fp32:
        return out

    # K7: unpolarized X + PZ on the initial density's fine box, with
    # exactly-zero and sub-threshold points
    rho_r = g_to_r(rho0, tables.fft_index, tables.dims).real.reshape(-1).clone()
    rho_r[:64] = 0.0
    rho_r[64:128] = 1e-14
    x_k = k7.lda_xc_unpolarized(rho_r)
    x_p = k7.lda_xc_unpolarized_plain(rho_r)
    record("lda_xc", list(x_k), list(x_p),
           lambda: k7.lda_xc_unpolarized(rho_r),
           lambda: k7.lda_xc_unpolarized_plain(rho_r), None,
           nbytes=nfine * 24, flops=nfine * K7_OPERATIONS)
    return out


def check_kernels_us(deck: str, ctx, dev, gpu: str, fp32: bool = False) -> dict:
    """K1c, K4, K5 and K6 against their plain versions at an ultrasoft +
    symmetry deck's main-path shapes; fp32: K1c's complex64 instantiation
    alone (K4-K6 have none). Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.density import (build_sym_pw_tables, grid_tables,
                                              initial_density_g)
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import symmetrize_pw as k6
    from sirius_tpu_torch.kernels import veff_multiply as k1c
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables

    nk, nb = ctx.gkvec.num_kpoints, ctx.num_bands
    n = int(np.prod(ctx.fft_coarse.dims))
    ng = ctx.gvec.num_gvec
    nbeta = ctx.beta.num_beta_total
    omega = float(ctx.unit_cell.omega)
    rng = np.random.default_rng(11)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)

    # K1c: one application to [X; P] of the band solve, B = nk, R = 2 nb
    rows = 2 * nb
    cb, rb, sfx = element_bytes(fp32)
    real = torch.float32 if fp32 else torch.float64
    veff = pot.veff_r_coarse.reshape(1, n).to(real)
    fr0 = torch.complex(torch.randn(nk, rows, n, dtype=real, device=dev),
                        torch.randn(nk, rows, n, dtype=real, device=dev))
    fr_k = k1c.veff_multiply(fr0.clone(), veff)
    fr_p = k1c.veff_multiply_plain(fr0.clone(), veff)
    fr_t = fr0.clone()
    bitwise = bool(torch.equal(fr_k, fr_p))
    record("veff_multiply" + sfx, [fr_k], [fr_p],
           lambda: k1c.veff_multiply(fr_t, veff),
           lambda: k1c.veff_multiply_plain(fr_t, veff),
           lambda: fr_t.mul_(veff[None]),
           nbytes=nk * rows * n * 2 * cb + n * rb, flops=nk * rows * n * 2.0,
           extra={"bitwise": bitwise})
    if not bitwise:
        raise AssertionError(f"veff_multiply{sfx} at {deck}: not bitwise "
                             "equal to its plain version")
    del fr0, fr_k, fr_p, fr_t
    if fp32:
        return out

    # K4 / K5: one atom type; a Hermitian density matrix and the potential
    # of the initial density
    aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                  dev)[0]
    check_rho_aug(out, deck, gpu, "augmentation.rho_aug", aug, 1, nbeta, rng,
                  dev)
    # K5 on the unpolarized potential (one channel)
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=dev)
    check_d_operator(out, deck, gpu, "augmentation.d_operator", aug,
                     pot.veff_g[None].contiguous(), dion, omega, dev)

    # K6: the rho_new symmetrization of the SCF (a scalar field), on the
    # initial density; yardstick: index_add_ over the JAX package's dense
    # per-op scatter table
    tb = tables.sym if tables.sym is not None else build_sym_pw_tables(ctx, dev)
    f = rho0.contiguous()
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.dims)
    nops = tb.num_ops
    m = tb.millers.long()
    idx = torch.empty((nops, ng), dtype=torch.int64, device=dev)
    x = m.to(torch.float64) @ tb.trans.T  # [ng, nops]: target phases
    arange = torch.arange(ng, device=dev)
    for op in range(nops):
        src, _ = k6.source_index(m, tb.rot[op], tb.lut, tb.dims)
        idx[op].scatter_(0, src, arange)  # source -> target
    vals = (f[None, :] * torch.polar(torch.ones_like(x.T),
                                     -2.0 * math.pi * x.T.gather(1, idx))
            ).reshape(-1)
    idx = idx.reshape(-1)
    del x

    def lib_sym():
        return torch.zeros_like(f).index_add_(0, idx, vals) / nops

    def fn_k(field):
        return k6.symmetrize_pw(field, *sargs, cosets=tb.cosets)

    def fn_p(field):
        return k6.symmetrize_pw_plain(field, *sargs)

    nbytes, flops, extra = symmetrize_work(tb, tb.cosets.live, 15.0)
    extra.update(random_field_errors("symmetrize_pw", fn_k, fn_p, (ng,), dev))
    extra["device_ms"] = device_ms(lambda: fn_k(f), dev, K6_DEVICE)
    record("symmetrize_pw", [fn_k(f)], [fn_p(f)], lambda: fn_k(f),
           lambda: fn_p(f), lib_sym, nbytes=nbytes, flops=flops,
           slow_plain=True, extra=extra)
    del idx, vals
    return out


def check_kernels_aug54(deck: str, ctx, dev, gpu: str, fm: dict) -> dict:
    """K4 at the 54-atom cell, where its launches cost the most: one
    channel, as the packed-real, chunked and fp32 runs launch it (returned),
    and two, as the PBE FM run does (into fm)."""
    import numpy as np

    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables

    aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                  dev)[0]
    rng = np.random.default_rng(54)
    out = {}
    nbeta = ctx.beta.num_beta_total
    check_rho_aug(out, deck, gpu, "augmentation.rho_aug.54", aug, 1, nbeta,
                  rng, dev)
    check_rho_aug(fm, deck + "_fm", gpu, "augmentation.rho_aug.2.54", aug, 2,
                  nbeta, rng, dev)
    return out


def check_rho_aug_strained(deck: str, ctx, dev, gpu: str) -> dict:
    """K4 on one strained table set of the stress (eps_xy = STRAIN_XY):
    the strained Q(G) of dft/stress.py::StressCalculator through
    ops/augmentation.py::with_q_tables, on seeded Hermitian density-matrix
    blocks of every atom, one channel (the charge), against the host
    rho_aug_g copy, its plain version, which the CPU runs (plain_ms is the
    host time). Yardstick, bound and plan as check_rho_aug's. K4 launches
    13 times a stress on one channel (12 strains and the unstrained
    charge), on two where the stress has a magnetization."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.stress import StressCalculator, dm_block_matrix
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.ops.augmentation import (build_aug_device_tables,
                                                   rho_aug_g,
                                                   rho_aug_g_device,
                                                   with_q_tables)

    uc, gvec = ctx.unit_cell, ctx.gvec
    calc = StressCalculator(ctx, XCFunctional(X_PZ), device=dev)
    eps = np.zeros((3, 3))
    eps[0, 1] = eps[1, 0] = STRAIN_XY
    q = calc.strained_q(eps)
    rng = np.random.default_rng(16)
    blocks = []
    for ia in range(uc.num_atoms):
        nbf = uc.atom_types[uc.type_of_atom[ia]].num_beta_lm
        a = rng.standard_normal((nbf, nbf)) + 1j * rng.standard_normal((nbf, nbf))
        blocks.append((a + a.conj().T) * 0.05)
    dm = torch.as_tensor(dm_block_matrix(ctx, blocks)[None], device=dev)
    q_dev = [torch.as_tensor(x, device=dev) for x in q if x is not None]
    tables = with_q_tables(build_aug_device_tables(uc, gvec, ctx.aug,
                                                   ctx.beta, dev), q_dev)
    ng = gvec.num_gvec

    def fn_k():
        return rho_aug_g_device(dm, tables, ng)

    def fn_p():
        return rho_aug_g(uc, gvec, ctx.aug, blocks, q)

    out = {}
    aug = tables[0]
    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    nbeta = ctx.beta.num_beta_total
    nrow = aug["pairs"].shape[0]
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    dmp = (aug["w"][None, None, :]
           * dm.reshape(1, -1)[:, aug["gidx"].long()].real
           ).to(torch.complex128)
    record_kernel(out, deck, gpu, "augmentation.rho_aug.strained",
                  [fn_k()[0]], [torch.as_tensor(fn_p(), device=dev)], fn_k,
                  fn_p,
                  lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, aug["q"]),
                  nbytes=nqlm * ng * 16 + ng * 16 + ng * 12
                  + nbeta * nbeta * 16,
                  flops=nrow * na * 7.0 + ng * nqlm * 8.0,
                  tensor_flops=nrow * na * nqlm * 4.0, slow_plain=True,
                  extra={"strain_xy": STRAIN_XY, "channels": 1, "atoms": na,
                         "num_gvec": ng, "rows": nrow,
                         "plan": k45.rho_aug_plan(na, nqlm, 1, nrow)})
    return out


def check_kernel_symmetrize(deck: str, ctx, dev, gpu: str) -> dict:
    """K6 on the rho_new symmetrization of a cell whose yardstick cannot be
    built: the initial density and a random field against the unfactorised
    plain version. The yardstick of the 16-atom record, index_add_ over the
    JAX package's dense per-op scatter table, holds nops x ng indices and
    values (30.6 GB at 54 atoms): it is not built, and the record says so.
    Returns {kernel: record}."""
    import torch

    from sirius_tpu_torch.dft.density import (build_sym_pw_tables,
                                              initial_density_g)
    from sirius_tpu_torch.kernels import symmetrize_pw as k6

    tb = build_sym_pw_tables(ctx, dev)
    f = torch.as_tensor(initial_density_g(ctx), device=dev)
    ng = f.shape[0]
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.dims)

    def fn_k(field):
        return k6.symmetrize_pw(field, *sargs, cosets=tb.cosets)

    def fn_p(field):
        return k6.symmetrize_pw_plain(field, *sargs)

    nbytes, flops, extra = symmetrize_work(tb, tb.cosets.live, 15.0)
    extra.update(random_field_errors("symmetrize_pw", fn_k, fn_p, (ng,), dev))
    extra["library"] = (f"index_add_ over the dense [nops, ng] table: "
                        f"{tb.num_ops * ng * 24 / 1e9:.1f} GB, not built")
    extra["device_ms"] = device_ms(lambda: fn_k(f), dev, K6_DEVICE)
    out = {}
    record_kernel(out, deck, gpu, "symmetrize_pw", [fn_k(f)], [fn_p(f)],
                  lambda: fn_k(f), lambda: fn_p(f), None, nbytes=nbytes,
                  flops=flops, slow_plain=True, extra=extra)
    return out


def check_kernels_gamma(deck: str, ctx, dev, gpu: str,
                        fp32: bool = False) -> dict:
    """K8a, K8b, K1c in real mode and K2 on float64 blocks against their
    plain versions at a Gamma deck's main-path shapes: one application to
    the packed [X; P] block of the band solve (R = 2 nb) and one residual
    of the nb-row block; fp32: their instantiations on float32 packed
    blocks, float32 tables and complex64 boxes. Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import gamma_pack as k8
    from sirius_tpu_torch.kernels import veff_multiply as k1c
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables
    from sirius_tpu_torch.ops.gamma import (apply_h_s_gamma, build_gamma_map,
                                            make_gamma_params)

    nb, ngk = ctx.num_bands, ctx.gkvec.ngk_max
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    rng = np.random.default_rng(13)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)
    gm = build_gamma_map(np.asarray(ctx.gkvec.millers[0]),
                         np.asarray(ctx.gkvec.mask[0]))
    cb, rb, _ = element_bytes(fp32)
    real = torch.float32 if fp32 else torch.float64
    sfx_r, sfx_c = (".f32", ".c64") if fp32 else ("", "")
    gp = make_gamma_params(ctx, pot.veff_r_coarse.cpu().numpy(), gm,
                           device=dev, dtype=real)
    npair = int(gp.rep_box.shape[0])
    rows = 2 * nb
    x = torch.as_tensor(rng.standard_normal((1, rows, ngk)),
                        device=dev).to(real)
    utabs = (gp.mask_p, gp.slot_re, gp.slot_im, gp.im_sign, gp.scale,
             gp.fft_index)

    # K8a: packed real -> complex box (zero fill and scatter)
    box = k8.unpack_to_box(x, *utabs, n)
    record("gamma_pack.unpack_to_box" + sfx_r, [box],
           [k8.unpack_to_box_plain(x, *utabs, n)],
           lambda: k8.unpack_to_box(x, *utabs, n),
           lambda: k8.unpack_to_box_plain(x, *utabs, n), None,
           nbytes=rows * ngk * rb + ngk * (12 + 3 * rb) + rows * n * cb,
           flops=rows * ngk * 3.0)

    # K1c real mode on the inverse transform of that box
    fr0 = torch.fft.ifftn(box.view((1, rows) + dims),
                          dim=(-3, -2, -1)).view(1, rows, n)
    del box
    veff = gp.veff_r.view(1, n)
    fr_k = k1c.veff_multiply_real(fr0.clone(), veff)
    fr_t = fr0.clone()
    # library yardstick: one in-place multiply of the (re, im) pairs by
    # (veff, 0), the pair table built once outside the timing
    vz = torch.stack([veff, torch.zeros_like(veff)], dim=-1)
    fr_v = torch.view_as_real(fr_t)
    fr_p = k1c.veff_multiply_real_plain(fr0, veff)
    bitwise = bool(torch.equal(fr_k, fr_p))
    # bytes: the whole complex element is read, not only its real half (a
    # warp's reads of the real parts fetch every 32-byte sector, imaginary
    # halves included), and written; the potential once
    record("veff_multiply.real" + sfx_c, [fr_k], [fr_p],
           lambda: k1c.veff_multiply_real(fr_t, veff),
           lambda: k1c.veff_multiply_real_plain(fr_t, veff),
           lambda: fr_v.mul_(vz),
           nbytes=rows * n * 2 * cb + n * rb, flops=rows * n * 1.0,
           extra={"bitwise": bitwise})
    if not bitwise:
        raise AssertionError(f"veff_multiply.real{sfx_c} at {deck}: not "
                             "bitwise equal to its plain version")
    del fr0, fr_t, fr_v, vz, fr_p

    # K8b: the forward transform gathered back into the packed slots
    vbox = torch.fft.fftn(fr_k.view((1, rows) + dims),
                          dim=(-3, -2, -1)).view(1, rows, n)
    del fr_k
    pargs = (gp.ekin_p, gp.mask_p, gp.rep_box, gp.par_box, gp.zero_box)
    hs_k = k8.box_to_packed_hx(vbox, x, *pargs)
    hs_p = k8.box_to_packed_hx_plain(vbox, x, *pargs)
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(hs_k, hs_p))
    record("gamma_pack.box_to_packed_hx" + sfx_r, list(hs_k), list(hs_p),
           lambda: k8.box_to_packed_hx(vbox, x, *pargs),
           lambda: k8.box_to_packed_hx_plain(vbox, x, *pargs), None,
           nbytes=(rows * (2 * npair + 1) * cb + rows * ngk * 3 * rb
                   + ngk * 2 * rb + npair * 8),
           flops=rows * ngk * 6.0,
           extra={"bitwise": bitwise,
                  "plan": k8.pack_plan(rows, ngk, npair)})
    if not bitwise:
        raise AssertionError(f"gamma_pack.box_to_packed_hx{sfx_r} at {deck}: "
                             "not bitwise equal to its plain version")
    del vbox, hs_k, hs_p

    # K2 on float64 blocks: x, H x, S x of the packed operator; row 0 an
    # exact eigenpair so the converged branch is exercised
    xs = x[:, :nb] * gp.mask_p
    hx, sx = apply_h_s_gamma(gp, xs)
    hx[:, 0] = 2.0 * sx[:, 0]
    hd = torch.as_tensor(rng.uniform(1.0, 3.0, (1, ngk)), device=dev).to(real)
    od = torch.ones((1, ngk), dtype=real, device=dev)
    mask = gp.mask_p[None]
    tol = 1e-3 if fp32 else 1e-6
    name = "davidson_residual" + (".f32" if fp32 else ".f64")
    r_k = k2.davidson_residual(xs, hx, sx, hd, od, mask, tol)
    if not bool((r_k[1][:, 0] < tol).all()):
        raise AssertionError(f"{name}: eigenpair row not converged")
    record(name, list(r_k),
           list(k2.davidson_residual_plain(xs, hx, sx, hd, od, mask, tol)),
           lambda: k2.davidson_residual(xs, hx, sx, hd, od, mask, tol),
           lambda: k2.davidson_residual_plain(xs, hx, sx, hd, od, mask, tol),
           None, nbytes=nb * ngk * 4 * rb + ngk * 3 * rb + nb * 2 * rb,
           flops=nb * ngk * 15.0,
           extra={**residual_plan(nb, ngk, rb, dev),
                  "device_ms": device_ms(
                      lambda: k2.davidson_residual(xs, hx, sx, hd, od, mask,
                                                   tol), dev,
                      ("residual_rows",))})
    if ctx.aug is not None and not fp32:
        # K5 at this cell's G sphere, on V and on the collinear (V + B_z,
        # V - B_z) pair of two channels (a random B_z): records only, the
        # summary's K5 rows are the 16-atom ones
        aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug,
                                      ctx.beta, dev)[0]
        dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=dev)
        bz = torch.as_tensor(rng.standard_normal(ctx.gvec.num_gvec) * 0.01,
                             device=dev).to(pot.veff_g.dtype)
        for v in (pot.veff_g[None], torch.stack([pot.veff_g + bz,
                                                 pot.veff_g - bz])):
            check_d_operator({}, deck, gpu, "augmentation.d_operator", aug,
                             v.contiguous(), dion,
                             float(ctx.unit_cell.omega), dev)
    return out


def check_kernel_chunk(deck: str, ctx, chunk: int, dev, gpu: str,
                       fp32: bool = False) -> dict:
    """K9 against its plain version for the first chunk step of a
    chunked-projector deck (chunk atoms a step); fp32: its complex64
    instantiation on the float32 tables. Returns {kernel: record}."""
    import torch

    from sirius_tpu_torch.kernels import beta_chunk as k9
    from sirius_tpu_torch.kernels import density_scatter as k16
    from sirius_tpu_torch.kernels import h_diag as k18
    from sirius_tpu_torch.ops.beta_chunked import make_chunked_hk

    cb, rb, sfx = element_bytes(fp32)
    prm = make_chunked_hk(ctx, 0, chunk=chunk, device=dev,
                          dtype=torch.complex64 if fp32 else torch.complex128)
    args = (prm.pos[0], prm.xi_rf[0], prm.xi_lm[0], prm.cph[0], prm.rlm,
            prm.q, prm.mk, prm.ri_grid, prm.dq, prm.pref, prm.mask[0])
    c, nxi = prm.xi_rf.shape[1:]
    ngk, lmmax = prm.rlm.shape
    nrf, nq = prm.ri_grid.shape
    # the radial-table entries this step reads: the two neighbours of each
    # G's grid point, per radial function
    i0 = torch.clamp(prm.q / prm.dq, 0.0, nq - 1.001).long()
    nread = int(torch.unique(torch.cat([i0, i0 + 1])).numel())
    out = {}
    record_kernel(out, deck, gpu, "beta_chunk" + sfx, [k9.beta_chunk(*args)],
                  [k9.beta_chunk_plain(*args)],
                  lambda: k9.beta_chunk(*args),
                  lambda: k9.beta_chunk_plain(*args), None,
                  nbytes=(c * nxi * ngk * cb + ngk * rb * (5 + lmmax)
                          + nrf * nread * rb + c * (3 * rb + nxi * (8 + cb))),
                  flops=c * nxi * ngk * 14.0 + c * ngk * 7.0 + ngk * 3.0,
                  extra={"plan": {"threads": 256,
                                  "blocks": [-(-ngk // 256), int(c)]}})
    return out


# fp64 operations a point of K7's closed form (X + PZ), cbrt, pow, log and
# sqrt counted as one each
K7_OPERATIONS = 60.0


def xc_operations(names, polarized: bool) -> float:
    """fp64 operations a point of K7b / K7g / K7s, by a stated rule: the
    torch operations of each functional's energy in the plain version (each
    elementary function, pow, exp, expm1, log, sqrt, atan, counted as one),
    times 1 + the number of partial derivatives the kernel carries for that
    term, plus the sigma and flux products of GGA and mGGA. K7b's compiled
    sets (X + PW92, X + VWN5) carry one partial a term (each exchange half
    its n_s, correlation rs, zeta by hand), its runtime-mask instantiation
    2; K7g's runtime-mask instantiation carries 5 partials polarized, 2
    unpolarized;
    K7g's compiled sets (PBE, PBEsol), term by term: exchange is one
    pbe_x_half per spin channel on Dual<2> polarized (two halves), one
    unpolarized (0.5 (x + x) = x), correlation runs on Dual<3> polarized,
    Dual<2> unpolarized. K7s, term by term: SCAN exchange is one
    scan_x_half per spin channel on Dual<3> polarized (two halves), one
    unpolarized; SCAN correlation runs on Dual<4> polarized, Dual<3>
    unpolarized; the LDA and GGA names of a mixed list on Dual<5>
    polarized, Dual<3> unpolarized."""
    import torch
    from torch.overrides import TorchFunctionMode

    from sirius_tpu_torch.kernels.gga_xc import COMPILED_SETS
    from sirius_tpu_torch.kernels.lda_xc import instantiation
    from sirius_tpu_torch.kernels.xc_functionals import (GGA_FUNCS,
                                                        MGGA_FUNCS, PBE_MU,
                                                        _pbe_x_half, energy,
                                                        func_mask, scan_c_e,
                                                        scan_x_half)

    count = [0]

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "__name__", "").startswith("__get"):
                count[0] += 1
            return func(*args, **(kwargs or {}))

    def ops(fn, *args) -> int:
        count[0] = 0
        with Count():
            fn(*args)
        return count[0]

    x = [torch.full((1,), v, dtype=torch.float64)
         for v in (0.31, 0.17, 0.05, 0.01, 0.04, 0.2, 0.1)]
    gga = any(n in GGA_FUNCS for n in names)
    mgga = any(n in MGGA_FUNCS for n in names)
    extra = (30.0 if polarized else 10.0) if (gga or mgga) else 0.0
    if gga and not mgga and func_mask(names) in COMPILED_SETS:
        half = ops(lambda n, s: _pbe_x_half(2 * n, 4 * s, PBE_MU), x[0], x[2])
        corr = next(n for n in names if "_C_" in n)
        return (((2 * half + 2) if polarized else half) * (1 + 2)
                + ops(GGA_FUNCS[corr], *x[:5]) * (1 + (3 if polarized else 2))
                + extra)
    if not mgga:
        partials = 5 if (gga and polarized) else 2
        if not gga and instantiation(names)[0] != "mask":
            partials = 1
        return ops(energy, list(names), *x) * (1.0 + partials) + extra
    total = 0.0
    for name in names:
        if name == "XC_MGGA_X_SCAN":
            # the channel's scalings 2 n, 4 sigma, 2 tau included; the
            # halves' sum and 0.5 factor are 2 more
            half = ops(lambda n, s, t: scan_x_half(2 * n, 4 * s, 2 * t),
                       x[0], x[2], x[5])
            total += ((2 * half if polarized else half) + 2) * (1 + 3)
        elif name == "XC_MGGA_C_SCAN":
            total += ops(scan_c_e, *x) * (1 + (4 if polarized else 3))
        else:
            total += ops(energy, [name], *x) * (1 + (5 if polarized else 3))
    return total + extra


def check_kernels_xc(deck: str, ctx, dev, gpu: str) -> dict:
    """K7b, K7g, K7s (each functional sum polarized and unpolarized), K10a
    and K10b against their plain versions on this deck's fine box: the
    initial density with a random polarization, exactly fully polarized
    points (one channel exactly 0) and dead points; for SCAN a kinetic-
    energy density per spin of random multiples (0.5 to 2) of the uniform-
    gas value plus the von Weizsaecker term, 0 (the first SCF potential's)
    on some points. Unpolarized X + PZ also bit for bit against the
    polarized launch at (rho/2, rho/2), and K10a bit for bit against its
    plain version on both fields and on one; either raises if not.
    Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.core.fftgrid import g_to_r, r_to_g
    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.potential import gradient_r
    from sirius_tpu_torch.kernels import gga_xc as k7g
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import mgga_xc as k7s
    from sirius_tpu_torch.kernels import xc_gradient as k10

    tables = grid_tables(ctx, dev)
    dims = tables.dims
    n = int(np.prod(dims))
    ng = ctx.gvec.num_gvec
    rng = np.random.default_rng(17)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    rho = g_to_r(rho0, tables.fft_index, dims).real.reshape(-1).clone()
    rho[:64] = 0.0
    rho[64:128] = 1e-14
    frac = torch.as_tensor(rng.uniform(-1.0, 1.0, n), device=dev)
    frac[128:192] = 1.0
    frac[192:256] = -1.0
    m = rho * frac
    nu, nd = 0.5 * (rho + m), 0.5 * (rho - m)
    mag_g = r_to_g(m.view(dims), tables.fft_index, dims)
    fields = torch.stack([0.5 * (rho0 + mag_g), 0.5 * (rho0 - mag_g)])
    g = gradient_r(tables, fields)
    gu, gd = g[0].view(3, n), g[1].view(3, n)
    g1 = gradient_r(tables, rho0[None])[0].view(3, n)
    del g
    tau_unif = 0.3 * (6.0 * math.pi**2) ** (2.0 / 3.0)

    def tau(n_s, grad):
        w = torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev)
        live = n_s > 1e-10
        t = (tau_unif * n_s.clamp(min=0.0) ** (5.0 / 3.0) * w
             + torch.where(live, (grad * grad).sum(0), 0.0)
             / (8.0 * n_s).clamp(min=1e-10))
        t[256:320] = 0.0
        return t

    tu, td = tau(nu, gu), tau(nd, gd)
    tt = tu + td

    for name, (names, pol) in XC_CHECKS.items():
        ops = K7_OPERATIONS if names == X_PZ else xc_operations(names, pol)
        if name.startswith("mgga_xc"):
            if pol:
                kern = functools.partial(k7s.mgga_xc, nu, nd, gu, gd, tu, td,
                                         names)
                plain = functools.partial(k7s.mgga_xc_plain, nu, nd, gu, gd,
                                          tu, td, names)
            else:
                kern = functools.partial(k7s.mgga_xc_unpolarized, rho, g1,
                                         tt, names)
                plain = functools.partial(k7s.mgga_xc_unpolarized_plain, rho,
                                          g1, tt, names)
            nbytes = n * (168.0 if pol else 88.0)
        elif name.startswith("lda_xc"):
            if pol:
                kern = functools.partial(k7.lda_xc, nu, nd, names)
                plain = functools.partial(k7.lda_xc_plain, nu, nd, names)
            else:
                kern = functools.partial(k7.lda_xc_unpolarized, rho, names)
                plain = functools.partial(k7.lda_xc_unpolarized_plain, rho,
                                          names)
            nbytes = n * (40.0 if pol else 24.0)
        else:
            if pol:
                kern = functools.partial(k7g.gga_xc, nu, nd, gu, gd, names)
                plain = functools.partial(k7g.gga_xc_plain, nu, nd, gu, gd,
                                          names)
            else:
                kern = functools.partial(k7g.gga_xc_unpolarized, rho, g1,
                                         names)
                plain = functools.partial(k7g.gga_xc_unpolarized_plain, rho,
                                          g1, names)
            nbytes = n * (136.0 if pol else 72.0)
        kind = {"lda_xc": k7, "gga_xc": k7g,
                "mgga_xc": k7s}[name.split(".")[0]]
        extra = {"instantiation": kind.instantiation(names)[0]}
        if name == PZ0:
            extra["bitwise_polarized"] = pz0_bitwise(rho)
        # no single PyTorch call evaluates a functional: library_ms null
        record(name, list(kern()), list(plain()), kern, plain, None,
               nbytes=nbytes, flops=n * ops, slow_plain=True, extra=extra)
        if name == PZ0 and not extra["bitwise_polarized"]:
            raise AssertionError(f"{PZ0} at {deck}: not bitwise the polarized "
                                 "launch at (rho/2, rho/2)")
    # K10b takes the forward FFT of the polarized PBE fluxes
    _, _, _, fu, fd = k7g.gga_xc(nu, nd, gu, gd, PBE)
    boxes = torch.fft.fftn(torch.stack([fu, fd]).view((2, 3) + dims).to(
        torch.complex128), dim=(-3, -2, -1), norm="forward").view(2, 3, n)
    del fu, fd, gu, gd, g1, tu, td, tt
    gargs = (tables.gcart, tables.fft_index)
    # K10a bitwise its plain version on both fields and on one (the SCAN
    # run's unpolarized gradient)
    bitwise = {f"bitwise_{s}_fields": bits_equal(
        k10.gradient_boxes(fields[:s], *gargs, n, tables.box_to_g),
        k10.gradient_boxes_plain(fields[:s], *gargs, n)) for s in (1, 2)}
    # no single PyTorch call forms i G_c f and scatters it, or gathers and
    # sums it: library_ms null
    record("xc_gradient.gradient_boxes",
           [k10.gradient_boxes(fields, *gargs, n, tables.box_to_g)],
           [k10.gradient_boxes_plain(fields, *gargs, n)],
           lambda: k10.gradient_boxes(fields, *gargs, n, tables.box_to_g),
           lambda: k10.gradient_boxes_plain(fields, *gargs, n), None,
           nbytes=2 * ng * 16 + ng * 28 + 2 * 3 * n * 16,
           flops=2 * ng * 6.0, extra=bitwise)
    if not all(bitwise.values()):
        raise AssertionError(f"gradient_boxes at {deck}: not bitwise equal to "
                             f"its plain version: {bitwise}")
    record("xc_gradient.divergence_pw", [k10.divergence_pw(boxes, *gargs)],
           [k10.divergence_pw_plain(boxes, *gargs)],
           lambda: k10.divergence_pw(boxes, *gargs),
           lambda: k10.divergence_pw_plain(boxes, *gargs), None,
           nbytes=2 * 3 * ng * 16 + ng * 28 + 2 * ng * 16,
           flops=2 * ng * 12.0)
    return out


def check_kernels_tau(deck: str, ctx, dev, gpu: str, fp32: bool = False) -> dict:
    """K11a and K11b against their plain versions at this deck's band-solve
    shapes: one component of the tau operator applied to the Davidson step's
    block [nk, nb, ngk], with non-zero values on the padded lanes (they
    point at the G = 0 slot). K11b adds its three components into H psi in
    order, the last one timed (it gathers the box and reads and writes
    hpsi); fp32: their complex64 instantiations on float32 G+k vectors.
    Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import mgga_tau as k11
    from sirius_tpu_torch.parallel.batched import make_hkset_params

    nk, nb, ngk = ctx.gkvec.num_kpoints, ctx.num_bands, ctx.gkvec.ngk_max
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    rng = np.random.default_rng(23)
    cb, rb, sfx = element_bytes(fp32)
    wf = torch.complex64 if fp32 else torch.complex128
    real = torch.float32 if fp32 else torch.float64
    hk = make_hkset_params(ctx, np.zeros(dims), device=dev, dtype=wf).hk()
    mask, idx = hk.mask, hk.fft_index
    gkc = torch.as_tensor(np.asarray(ctx.gkvec.gkcart, dtype=np.float64),
                          device=dev).to(real)
    psi = torch.as_tensor(rng.standard_normal((nk, nb, ngk))
                          + 1j * rng.standard_normal((nk, nb, ngk)),
                          device=dev).to(wf)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)

    # yardstick: the scatter as one index_put_ into a zeroed box
    bi, gi = torch.nonzero(mask > 0, as_tuple=True)
    rows = (bi[:, None] * nb
            + torch.arange(nb, device=dev)[None, :]).reshape(-1)
    cols = idx[bi, gi].long().repeat_interleave(nb)
    vals = (gkc[bi, gi, 1][:, None] * psi.permute(0, 2, 1)[bi, gi]).reshape(-1)

    def lib_scatter():
        z = torch.zeros((nk * nb, n), dtype=wf, device=dev)
        return z.index_put_((rows, cols), vals)

    args = (psi, gkc, 1, idx, mask, n)
    record("mgga_tau.grad_to_box" + sfx, [k11.grad_to_box(*args)],
           [k11.grad_to_box_plain(*args)],
           lambda: k11.grad_to_box(*args),
           lambda: k11.grad_to_box_plain(*args), lib_scatter,
           nbytes=nk * nb * ngk * cb + nk * ngk * (4 + 2 * rb)
           + nk * nb * n * cb,
           flops=nk * nb * ngk * 2.0)
    del vals, rows, cols

    boxes = [k11.grad_to_box(psi, gkc, c, idx, mask, n) for c in range(3)]
    h0 = torch.as_tensor(rng.standard_normal((nk, nb, ngk))
                         + 1j * rng.standard_normal((nk, nb, ngk)),
                         device=dev).to(wf)

    def run(fn):
        h = h0.clone()
        for c in range(3):
            fn(boxes[c], gkc, c, idx, mask, h)
        return h

    h_t = run(k11.box_to_pw_tau)
    gidx = idx.long()[:, None, :].expand(nk, nb, ngk)
    record("mgga_tau.box_to_pw_tau" + sfx, [run(k11.box_to_pw_tau)],
           [run(k11.box_to_pw_tau_plain)],
           lambda: k11.box_to_pw_tau(boxes[2], gkc, 2, idx, mask, h_t),
           lambda: k11.box_to_pw_tau_plain(boxes[2], gkc, 2, idx, mask, h_t),
           lambda: torch.gather(boxes[2], 2, gidx),
           nbytes=nk * nb * ngk * 3 * cb + nk * ngk * (4 + 2 * rb),
           flops=nk * nb * ngk * 8.0)
    return out


def check_kernel_axial(deck: str, ctx, dev, gpu: str) -> dict:
    """K6 on an axial field (the op's spin sign applied) against its plain
    version, on this deck's initial magnetization. Returns {kernel:
    record}."""
    import torch

    from sirius_tpu_torch.dft.density import (build_sym_pw_tables,
                                              initial_magnetization_g)
    from sirius_tpu_torch.kernels import symmetrize_pw as k6

    tb = build_sym_pw_tables(ctx, dev)
    f = torch.as_tensor(initial_magnetization_g(ctx), device=dev)
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.dims, tb.sign)

    def fn_k(field):
        return k6.symmetrize_pw(field, *sargs, cosets=tb.cosets)

    def fn_p(field):
        return k6.symmetrize_pw_plain(field, *sargs)

    nbytes, flops, extra = symmetrize_work(tb, tb.cosets.live_axial, 16.0)
    extra.update(random_field_errors("symmetrize_pw.axial", fn_k, fn_p,
                                     (f.shape[0],), dev))
    extra["device_ms"] = device_ms(lambda: fn_k(f), dev, K6_DEVICE)
    out = {}
    record_kernel(out, deck, gpu, "symmetrize_pw.axial", [fn_k(f)], [fn_p(f)],
                  lambda: fn_k(f), lambda: fn_p(f), None, nbytes=nbytes,
                  flops=flops, slow_plain=True, extra=extra)
    return out


def check_kernels_spinor(deck: str, ctx, dev, gpu: str,
                         fp32: bool = False) -> dict:
    """K12a, K12b, K6v, K4 and K5 on four channels against their plain
    versions at a non-collinear deck's main-path shapes: the spinor
    potential of the initial density and magnetization on the k-set's
    [nk nb, 2, n] box (a Davidson step's block), the four-component density
    of one k-point's [nb, 2, n] box, the axial-vector symmetrization of the
    initial B field over the magnetic group, rho_aug of four Hermitian
    component blocks, D of (V, B_x, B_y, B_z); fp32: the complex64
    instantiations of K12a (float32 fields) and K12b alone (K6v, K4 and K5
    have none). Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.density import (build_sym_pw_tables, grid_tables,
                                              initial_density_g,
                                              initial_magnetization_vec_g)
    from sirius_tpu_torch.dft.potential_nc import generate_potential_nc
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import density_accumulate_nc as k12b
    from sirius_tpu_torch.kernels import spinor_veff as k12a
    from sirius_tpu_torch.kernels import symmetrize_pw as k6
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables

    nk, nb = ctx.gkvec.num_kpoints, ctx.num_bands
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    ng = ctx.gvec.num_gvec
    nbeta = ctx.beta.num_beta_total
    rng = np.random.default_rng(31)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    m0 = torch.as_tensor(initial_magnetization_vec_g(ctx), device=dev)
    pot = generate_potential_nc(ctx, rho0, XCFunctional(["XC_LDA_X",
                                                         "XC_LDA_C_PZ"]),
                                m0, tables)
    cb, rb, sfx = element_bytes(fp32)
    real = torch.float32 if fp32 else torch.float64
    v = pot.veff_boxes.view(4, n).to(real)

    # K12a: in place on [nk nb, 2, n], the whole k-set's block of a
    # Davidson step (22 of the 25 launches of an iteration; the three
    # [X; P] refreshes take twice the rows). Yardstick: one einsum of the
    # [2, 2, n] complex potential, built outside the timing, with the box
    rows = nk * nb
    fr0 = torch.complex(torch.randn(rows, 2, n, dtype=real, device=dev),
                        torch.randn(rows, 2, n, dtype=real, device=dev))
    fr_k = k12a.spinor_veff(fr0.clone(), *v)
    fr_p = k12a.spinor_veff_plain(fr0.clone(), *v)
    fr_t = fr0.clone()
    vmat = spinor_potential_matrix(*v)
    record("spinor_veff" + sfx, [fr_k], [fr_p],
           lambda: k12a.spinor_veff(fr_t, *v),
           lambda: k12a.spinor_veff_plain(fr_t, *v),
           lambda: torch.einsum("sti,rti->rsi", vmat, fr0),
           nbytes=rows * 2 * n * 2 * cb + 4 * n * rb, flops=rows * n * 20.0)
    del fr_k, fr_p, fr_t

    # K12b: the four fields of one k-point's box (one launch per k-point)
    fr1 = fr0[:nb]
    occ = torch.as_tensor(rng.uniform(0.0, 0.25, nb), device=dev)
    acc0 = torch.as_tensor(rng.uniform(0.0, 1.0, (4, n)), device=dev)
    acc_t = acc0.clone()
    record("density_accumulate_nc" + sfx,
           [k12b.density_accumulate_nc(acc0.clone(), fr1, occ, float(n) ** 2)],
           [k12b.density_accumulate_nc_plain(acc0.clone(), fr1, occ,
                                             float(n) ** 2)],
           lambda: k12b.density_accumulate_nc(acc_t, fr1, occ, float(n) ** 2),
           lambda: k12b.density_accumulate_nc_plain(acc_t, fr1, occ,
                                                    float(n) ** 2),
           None, nbytes=nb * 2 * n * cb + 4 * n * 16 + nb * 8,
           flops=nb * n * 20.0 + n * 12.0)
    del fr0, fr1, acc_t
    if fp32:
        return out

    # K6v: the unsymmetrized B field of the initial potential; yardstick:
    # index_add_ over the JAX package's dense per-op scatter table, with the
    # rotated and phased values built outside the timing
    tb = tables.sym if tables.sym is not None else build_sym_pw_tables(ctx,
                                                                       dev)
    f = pot.bvec_g.contiguous()
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.srot, tb.dims)
    nops = tb.num_ops
    m = tb.millers.long()
    idx = torch.empty((nops, ng), dtype=torch.int64, device=dev)
    vals = torch.empty((3, nops, ng), dtype=torch.complex128, device=dev)
    arange = torch.arange(ng, device=dev)
    x = m.to(torch.float64) @ tb.trans.T  # [ng, nops]: target phases
    for op in range(nops):
        src, _ = k6.source_index(m, tb.rot[op], tb.lut, tb.dims)
        idx[op].scatter_(0, src, arange)  # source -> target
        ph = torch.polar(torch.ones_like(x[:, op]), -2.0 * math.pi * x[:, op])
        # the value the target g gathers from its source, stored at the
        # source's slot of this op's row (index_add_ sends it back to g)
        vals[:, op].index_copy_(1, src,
                                (tb.srot[op].to(f.dtype) @ f[:, src]) * ph)
    idx = idx.reshape(-1)
    vals = vals.reshape(3, -1)
    del x

    def lib_sym():
        return torch.zeros_like(f).index_add_(1, idx, vals) / nops

    def fn_k(field):
        return k6.symmetrize_vector_pw(field, *sargs, cosets=tb.cosets)

    def fn_p(field):
        return k6.symmetrize_vector_pw_plain(field, *sargs)

    nbytes, flops, extra = symmetrize_work(tb, tb.cosets.live, 60.0, ncomp=3)
    extra.update(random_field_errors("symmetrize_vector_pw", fn_k, fn_p,
                                     (3, ng), dev))
    extra["device_ms"] = device_ms(lambda: fn_k(f), dev,
                                   ("symmetrize_vector_kernel", "Memset"))
    record("symmetrize_vector_pw", [fn_k(f)], [fn_p(f)], lambda: fn_k(f),
           lambda: fn_p(f), lib_sym, nbytes=nbytes, flops=flops,
           slow_plain=True, extra=extra)
    del idx, vals

    # K4 on the four (rho, m_x, m_y, m_z) Hermitian component blocks
    aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                  dev)[0]
    check_rho_aug(out, deck, gpu, "augmentation.rho_aug.4", aug, 4, nbeta,
                  rng, dev)

    # K5 on the four channels (V, B_x, B_y, B_z) of the initial potential,
    # D_ion on V alone, as dft/scf_nc.py launches it
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=dev)
    zero = torch.zeros_like(dion)
    check_d_operator(out, deck, gpu, "augmentation.d_operator.4", aug,
                     torch.cat([pot.veff_g[None], pot.bvec_g]).contiguous(),
                     torch.stack([dion, zero, zero, zero]),
                     float(ctx.unit_cell.omega), dev)
    return out


def spinor_potential_matrix(v_uu, v_dd, b_x, b_y):
    """The [2, 2, n] complex potential that K12a applies per point:
    [[v_uu, B_x - i B_y], [B_x + i B_y, v_dd]]."""
    import torch

    off = torch.complex(b_x, b_y)
    return torch.stack([torch.stack([v_uu.to(off.dtype), off.conj()]),
                        torch.stack([off, v_dd.to(off.dtype)])])


def wrappers() -> dict:
    """The kernel wrappers by summary name, each with the attribute that
    holds its launch count (K2 counts its float64 launches apart, and every
    fp32 instantiation counts on its wrapper's launches_c64 or
    launches_f32)."""
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import beta_chunk as k9
    from sirius_tpu_torch.kernels import density_scatter as k16
    from sirius_tpu_torch.kernels import h_diag as k18
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import density_accumulate as k3
    from sirius_tpu_torch.kernels import density_accumulate_nc as k12b
    from sirius_tpu_torch.kernels import gamma_pack as k8
    from sirius_tpu_torch.kernels import gga_xc as k7g
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import local_hpsi as k1
    from sirius_tpu_torch.kernels import mgga_tau as k11
    from sirius_tpu_torch.kernels import mgga_xc as k7s
    from sirius_tpu_torch.kernels import spinor_veff as k12a
    from sirius_tpu_torch.kernels import symmetrize_pw as k6
    from sirius_tpu_torch.kernels import fermi as k13
    from sirius_tpu_torch.kernels import mixer as k14
    from sirius_tpu_torch.kernels import scf_record as k15
    from sirius_tpu_torch.kernels import veff_multiply as k1c
    from sirius_tpu_torch.kernels import xc_gradient as k10
    from sirius_tpu_torch.kernels import coarse_potential as k17d
    from sirius_tpu_torch.kernels import hartree_veff as k17c
    from sirius_tpu_torch.kernels import xc_inputs as k17a
    from sirius_tpu_torch.kernels import xc_outputs as k17b

    n = "launches"
    # K7, K7g and K7s count each instantiation (launches_pw92,
    # launches_pbe, launches_scan, ...), X + PZ its unpolarized and its
    # polarized kernel apart
    xc = {}
    for name, (names, pol) in XC_CHECKS.items():
        mod = {"lda_xc": k7, "gga_xc": k7g,
               "mgga_xc": k7s}[name.split(".")[0]]
        kind = mod.instantiation(names)[0]
        if mod is k7 and kind == "pz":
            kind += "_polarized" if pol else "_unpolarized"
        xc[name] = (getattr(mod, name.split(".")[0]), n + "_" + kind)
    out = {"local_hpsi.pw_to_box": (k1.pw_to_box, n),
           "local_hpsi.box_to_pw_hpsi": (k1.box_to_pw_hpsi, n),
           "davidson_residual": (k2.davidson_residual, n),
           "density_accumulate": (k3.density_accumulate, n),
           "lda_xc": (k7.lda_xc, n),
           "veff_multiply": (k1c.veff_multiply, n),
           "augmentation.rho_aug": (k45.rho_aug, n),
           "augmentation.d_operator": (k45.d_operator, n),
           "symmetrize_pw": (k6.symmetrize_pw, n),
           "gamma_pack.unpack_to_box": (k8.unpack_to_box, n),
           "gamma_pack.box_to_packed_hx": (k8.box_to_packed_hx, n),
           "veff_multiply.real": (k1c.veff_multiply_real, n),
           "davidson_residual.f64": (k2.davidson_residual, "launches_f64"),
           "beta_chunk": (k9.beta_chunk, n),
           **xc,
           "xc_gradient.gradient_boxes": (k10.gradient_boxes, n),
           "xc_gradient.divergence_pw": (k10.divergence_pw, n),
           "symmetrize_pw.axial": (k6.symmetrize_pw, "launches_axial"),
           "mgga_tau.grad_to_box": (k11.grad_to_box, n),
           "mgga_tau.box_to_pw_tau": (k11.box_to_pw_tau, n),
           "spinor_veff": (k12a.spinor_veff, n),
           "density_accumulate_nc": (k12b.density_accumulate_nc, n),
           "symmetrize_vector_pw": (k6.symmetrize_vector_pw, n),
           "augmentation.rho_aug.4": (k45.rho_aug, n),
           "augmentation.d_operator.4": (k45.d_operator, n),
           "augmentation.rho_aug.54": (k45.rho_aug, n),
           "augmentation.rho_aug.2.54": (k45.rho_aug, n),
           "augmentation.rho_aug.strained": (k45.rho_aug, n),
           "fermi": (k13.find_fermi, n),
           "mixer.gram": (k14.mixer_gram, n),
           "mixer.update": (k14.mixer_update, n),
           "scf_record": (k15.scf_record, n),
           "density_scatter.coarse_box": (k16.coarse_box, n),
           "density_scatter.scatter_fine": (k16.scatter_fine, n),
           "h_diag": (k18.h_diag_pass, n)}
    k17 = {"potential_passes.xc_inputs": k17a.xc_inputs,
           "potential_passes.xc_outputs": k17b.xc_outputs,
           "potential_passes.hartree_veff": k17c.hartree_veff,
           "potential_passes.gga_inputs": k17c.gga_inputs,
           "potential_passes.coarse_fill": k17d.coarse_fill,
           "potential_passes.coarse_stack": k17d.coarse_stack}
    out.update({name: (k17[k17_base(name)], n) for name in K17_NAMES})
    for name in FP32_SUMMARY:
        out[name] = (out[base_name(name)][0],
                     "launches_" + name.rsplit(".", 1)[1])
    return out


# the kernels each SCF path must launch: the norm-conserving k-set path runs
# K1, K1c, K2, K3 and K7 (unpolarized X + PZ: its zeta = 0 kernel); ultrasoft
# + symmetry adds K4, K5 and K6. The Gamma
# path applies H through K8a, K1c real, K8b and solves with K2 float64 (the
# density keeps K1's scatter and K3); the chunked path adds K9 to the k-set
# path's kernels
# every collinear path's potential runs K17a, K17b, K17c (i) and both
# passes of K17d (POTENTIAL); a polarized GGA or mGGA one K17c (ii) too
# (GGA_INPUTS; unpolarized it forms rows only from a core charge, which no
# deck has); the non-collinear potential takes K17c (i) and K17d's fill
# (POTENTIAL_NC)
POTENTIAL = K17_UNPOLARIZED
GGA_INPUTS = "potential_passes.gga_inputs"
POTENTIAL_NC = ("potential_passes.hartree_veff", "potential_passes.coarse_fill")
NC_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
              "davidson_residual", "density_accumulate", "lda_xc", PZ0,
              "veff_multiply", "fermi") + POTENTIAL
US_KERNELS = NC_KERNELS + ("augmentation.rho_aug", "augmentation.d_operator",
                           "symmetrize_pw")
# every path runs K13, K16a, K16b and K18 (EVERY_PATH, which
# check_launched adds); a deck that fuses (dft/scf.py::fuses: the k-set
# solve, no mGGA, linear or Anderson mixing) runs the fused step's K14a,
# K14b and K15 too
EVERY_PATH = ("density_scatter.coarse_box", "density_scatter.scatter_fine",
              "h_diag")
FUSED_STEP = ("mixer.gram", "mixer.update", "scf_record")
NC_FUSED = NC_KERNELS + FUSED_STEP
US_FUSED = US_KERNELS + FUSED_STEP
GAMMA_KERNELS = ("local_hpsi.pw_to_box", "density_accumulate", "lda_xc", PZ0,
                 "gamma_pack.unpack_to_box", "gamma_pack.box_to_packed_hx",
                 "veff_multiply.real", "davidson_residual.f64",
                 "fermi") + POTENTIAL
GAMMA_US_KERNELS = GAMMA_KERNELS + ("augmentation.rho_aug",
                                    "augmentation.d_operator", "symmetrize_pw")
CHUNKED_US_KERNELS = US_KERNELS + ("beta_chunk",)
# the band solve each single-k deck takes, and the kernels it must launch
SINGLE_K_PATH = {"gamma_nc": ("gamma", GAMMA_KERNELS),
                 "gamma_us_sym": ("gamma", GAMMA_US_KERNELS),
                 "chunked_us_sym": ("chunked", CHUNKED_US_KERNELS)}
GGA_KERNELS = ("gga_xc.pbe", "xc_gradient.gradient_boxes",
               "xc_gradient.divergence_pw")
# SCAN on the k-set path: K7s, the gradient halves and the tau operator
MGGA_KERNELS = ("mgga_xc.scan", "xc_gradient.gradient_boxes",
                "xc_gradient.divergence_pw", "mgga_tau.grad_to_box",
                "mgga_tau.box_to_pw_tau")


def xc_kernels(base, gga: bool, axial: bool, mgga: bool = False,
               gga_set: str = "gga_xc.pbe", lda_set: str = "",
               polarized: bool = False) -> tuple:
    """A path's kernels for a deck of other functionals or spin: none runs
    unpolarized X + PZ's kernel; an LDA deck runs K7 in its instantiation
    lda_set; GGA runs K7g (its instantiation gga_set), K10a and K10b in
    place of K7, SCAN K7s, K10a, K10b, K11a and K11b; a deck with
    symmetry on axial fields (collinear polarized) runs K6 on them too,
    and a collinear polarized GGA or SCAN deck K17c (ii)."""
    out = tuple(k for k in base if k != PZ0
                and not ((gga or mgga) and k.startswith("lda_xc")))
    return out + ((lda_set,) if lda_set else ()) + (
        MGGA_KERNELS if mgga else (gga_set,) + GGA_KERNELS[1:]
        if gga else ()) + (("symmetrize_pw.axial",) if axial else ()) + (
        (GGA_INPUTS,) if polarized and (gga or mgga) else ())


# the band solve each deck of XC_DECKS takes, and the kernels it must launch
XC_DECK_PATH = {
    "pbe_us_sym": ("kset", xc_kernels(US_FUSED, True, False)),
    "pw_us_sym_afm": ("kset", xc_kernels(US_FUSED, False, True,
                                         lda_set="lda_xc.pw92",
                                         polarized=True)),
    "gamma_pbe_us_sym_fm": ("gamma", xc_kernels(GAMMA_US_KERNELS, True, True,
                                                polarized=True)),
    "gamma_nc_vwn": ("gamma", xc_kernels(GAMMA_KERNELS, False, False,
                                         lda_set="lda_xc.vwn.unpolarized")),
    "gamma_nc_pbesol": ("gamma", xc_kernels(GAMMA_KERNELS, True, False,
                                            gga_set="gga_xc.pbesol")),
    "scan_us_sym": ("kset", xc_kernels(US_KERNELS, False, False, mgga=True)),
    "scan_us_sym_fm": ("kset", xc_kernels(US_KERNELS, False, True,
                                          mgga=True, polarized=True)),
}
# the spinor k-set path: K1 over (band, spin) rows, K12a in place of K1c,
# K2 on the flattened spinors, K12b in place of K3, K4 and K5 on four
# channels, K6 on rho and V_eff and K6v on m and B with symmetry; LDA runs
# K7's polarized X + PZ kernel on the |m|-projected channels, PBE K7g,
# K10a and K10b
SPINOR_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
                  "davidson_residual", "spinor_veff", "density_accumulate_nc",
                  "lda_xc", "lda_xc.pz", "augmentation.rho_aug.4",
                  "augmentation.d_operator.4", "fermi") + POTENTIAL_NC
SPINOR_SYM_KERNELS = SPINOR_KERNELS + ("symmetrize_pw", "symmetrize_vector_pw")
SPINOR_DECK_PATH = {
    "small_spinor_us": SPINOR_KERNELS,
    "small_spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
    "spinor_us": SPINOR_KERNELS,
    "spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
}
# spin-orbit (parameters.so_correction): the reference tool's FILE_DECKS,
# built from the deck and UPF species file it writes (deck_context). The
# norm-conserving deck launches no augmentation kernel. The spin-orbit term
# pins the moments to the lattice: every component is held to
# SO_MOMENT_TOL. full_width_spinor_so_us is full_width_spinor_us's cell
# with the spin-orbit species
SPINOR_NC_KERNELS = tuple(k for k in SPINOR_KERNELS
                          if not k.startswith("augmentation"))
SO_DECK_PATH = {"so_nc": SPINOR_NC_KERNELS, "so_us_sym": SPINOR_SYM_KERNELS}
SO_MOMENT_TOL = 1e-6
FULL_ITERS["full_width_spinor_so_us"] = 4
# the quasi-Newton mixers of the reference tool on the 2-atom ultrasoft
# deck with the space group
MIXER_DECKS = ("anderson_stable_us_sym", "broyden2_us_sym")
FULL_GAMMA_PBE_FM_KERNELS = xc_kernels(GAMMA_US_KERNELS, True, True,
                                       polarized=True)
# the recorded force decks: the band solve each takes, the kernels its SCF
# must launch, and those its stress must launch (K1's scatter of the
# strained densities, the XC kernel of the deck's functional, K10a for
# GGA's strained gradients, K4 on strained tables for ultrasoft species)
STRESS_LDA_KERNELS = ("local_hpsi.pw_to_box", PZ0)
STRESS_US_KERNELS = STRESS_LDA_KERNELS + ("augmentation.rho_aug",)
FORCES_DECK_PATH = {
    "forces_nc": ("gamma", GAMMA_KERNELS, STRESS_LDA_KERNELS),
    "forces_us": ("gamma", tuple(k for k in GAMMA_US_KERNELS
                                 if k != "symmetrize_pw"), STRESS_US_KERNELS),
    "forces_us_sym_2atom": ("kset", US_FUSED, STRESS_US_KERNELS),
    "forces_gamma_pbe_fm": ("gamma", xc_kernels(GAMMA_US_KERNELS, True, True,
                                                polarized=True),
                            ("local_hpsi.pw_to_box", "gga_xc.pbe",
                             "xc_gradient.gradient_boxes",
                             "augmentation.rho_aug")),
}
FULL_SCAN_KERNELS = xc_kernels(US_KERNELS, False, False, mgga=True)
# the fp32 paths: the band solve (and on the k-set path the density's
# transforms) through the fp32 instantiations, the rest of the iteration in
# fp64. The Gamma and chunked paths hand the density complex128 bands (K1's
# fp64 scatter and K3), as the JAX package does
FP32_US_KERNELS = ("local_hpsi.pw_to_box.c64", "local_hpsi.box_to_pw_hpsi.c64",
                   "veff_multiply.c64", "davidson_residual.c64",
                   "density_accumulate.c64", "lda_xc", PZ0,
                   "augmentation.rho_aug", "augmentation.d_operator",
                   "symmetrize_pw", "fermi") + POTENTIAL
FP32_US_FUSED = FP32_US_KERNELS + FUSED_STEP
FP32_GAMMA_US_KERNELS = ("gamma_pack.unpack_to_box.f32",
                         "veff_multiply.real.c64",
                         "gamma_pack.box_to_packed_hx.f32",
                         "davidson_residual.f32", "local_hpsi.pw_to_box",
                         "density_accumulate", "lda_xc", PZ0,
                         "augmentation.rho_aug", "augmentation.d_operator",
                         "symmetrize_pw", "fermi") + POTENTIAL
FP32_CHUNKED_US_KERNELS = ("local_hpsi.pw_to_box.c64",
                           "local_hpsi.box_to_pw_hpsi.c64",
                           "veff_multiply.c64", "davidson_residual.c64",
                           "beta_chunk.c64", "local_hpsi.pw_to_box",
                           "density_accumulate", "lda_xc", PZ0,
                           "augmentation.rho_aug", "augmentation.d_operator",
                           "symmetrize_pw", "fermi") + POTENTIAL
FP32_SCAN_KERNELS = tuple(k for k in FP32_US_KERNELS
                          if k not in ("lda_xc", PZ0)) + (
    "mgga_xc.scan", "xc_gradient.gradient_boxes", "xc_gradient.divergence_pw",
    "mgga_tau.grad_to_box.c64", "mgga_tau.box_to_pw_tau.c64")
FP32_SPINOR_SYM_KERNELS = ("local_hpsi.pw_to_box.c64",
                           "local_hpsi.box_to_pw_hpsi.c64",
                           "davidson_residual.c64", "spinor_veff.c64",
                           "density_accumulate_nc.c64", "lda_xc",
                           "lda_xc.pz", "augmentation.rho_aug.4",
                           "augmentation.d_operator.4", "symmetrize_pw",
                           "symmetrize_vector_pw",
                           "fermi") + POTENTIAL_NC
# the fp32 parity decks of the reference tool (each beside its fp64 twin
# there): the band solve each takes and the kernels it must launch
FP32_DECK_PATH = {
    "fp32_us_sym_polish": ("kset", FP32_US_FUSED),
    "fp32_us_sym_fixed8": ("kset", FP32_US_FUSED),
    "gamma_us_sym_fp32": ("gamma", FP32_GAMMA_US_KERNELS),
    "chunked_us_sym_fp32": ("chunked", FP32_CHUNKED_US_KERNELS),
    "scan_us_sym_fp32": ("kset", FP32_SCAN_KERNELS),
    "small_spinor_pbe_us_sym_fp32": (
        "kset_nc", xc_kernels(FP32_SPINOR_SYM_KERNELS, True, False)),
}
# the band-solve kernels by instantiation: a band solve on complex64 or
# float32 blocks launches none of the fp64 ones
BAND_SOLVE_FP64 = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
                   "veff_multiply", "veff_multiply.real", "davidson_residual",
                   "davidson_residual.f64", "gamma_pack.unpack_to_box",
                   "gamma_pack.box_to_packed_hx", "beta_chunk",
                   "mgga_tau.grad_to_box", "mgga_tau.box_to_pw_tau",
                   "spinor_veff")
# the full-width fp32 runs: the 16-atom US cell with the polish, and the
# 54-atom Gamma and 16-atom spinor cells in fp32 throughout
FULL_ITERS.update(full_width_us_fp32=6, full_width_gamma_us_fp32=4,
                  full_width_spinor_us_fp32=4)


def fp32_electron_tol(refs: dict, nel: float) -> float:
    """The electron-count limit of a full-width fp32 run: its bands are
    S-normalized to fp32 rounding, so the count is off by ~1e-7 per
    electron, in the JAX package too (and a run polished for its last
    iterations still mixes the earlier densities). 4x the JAX package's
    largest relative electron-count gap over its pure-fp32 records, times
    nel."""
    rel = max(r["twin_electron_gap"] / refs[r["twin"]]["electrons"]
              for r in refs.values() if "twin_electron_gap" in r)
    return 4.0 * rel * nel


def polish_threshold(rms_history) -> float:
    """fp32_to_fp64_rms of full_width_us_fp32, taken from the density
    residuals of the fp64 full_width_us run of the same call: the geometric
    mean of those after iterations 3 and 4, so the switch fires after
    iteration 4 (after 3 if the fp32 trajectory runs ahead) with a margin
    of the square root of their ratio either way."""
    return math.sqrt(rms_history[2] * rms_history[3])


def reset_launches() -> None:
    for f, attr in wrappers().values():
        setattr(f, attr, 0)


def read_launches() -> dict:
    return {name: getattr(f, attr) for name, (f, attr) in wrappers().items()}


def check_launched(phase: str, dev, launches: dict, required,
                   path: str = "kset", iters: int = 0,
                   polarized: bool = False) -> None:
    """Fail unless every kernel of the path launched in this run (and
    K16a, K16b and K18, which every path runs). On the Gamma path H is
    applied without K1's gather: the run's gathers are the r -> G
    transforms of the potential only, one per potential (two polarized:
    V_xc and B_z) for iters + 1 potentials (the density's transform is
    K16's). On the CPU the wrappers take their plain versions and count
    nothing."""
    if dev.type != "cuda":
        return
    zero = [k for k in tuple(required) + EVERY_PATH if launches[k] <= 0]
    if zero:
        raise AssertionError(f"{phase}: kernels never launched: {zero}")
    gathers = launches["local_hpsi.box_to_pw_hpsi"]
    want = (2 if polarized else 1) * (iters + 1)
    if path == "gamma" and gathers != want:
        raise AssertionError(
            f"{phase}: {gathers} K1 gathers, want {want} (r -> G only): "
            "H psi went through K1")
    # the spinor path has K12a and K12b in place of K1c and K3
    scalar = {k: launches[k] for k in ("veff_multiply", "density_accumulate")
              if launches[k]}
    if path == "kset_nc" and scalar:
        raise AssertionError(f"{phase}: scalar kernels on the spinor path: "
                             f"{scalar}")


@contextlib.contextmanager
def watch_eigh():
    """Count the run's torch.linalg.eigh calls by the type and order of
    the matrix cuSOLVER is handed ({"torch.float64 387": n, ...}): the
    route each subspace type takes (solvers/davidson.py::EIGH_TYPE)."""
    import torch

    calls: dict = {}
    eigh = torch.linalg.eigh

    def counted(a, *args, **kw):
        key = f"{a.dtype} {a.shape[-1]}"
        calls[key] = calls.get(key, 0) + 1
        return eigh(a, *args, **kw)

    torch.linalg.eigh = counted
    try:
        yield calls
    finally:
        torch.linalg.eigh = eigh


def empty_rows_pair(seed: int = 16):
    """(hsub, ssub) [1, 42, 42] complex128 on the CPU: the S-subspace matrix
    on which cuSOLVER's heevd failed to converge in a fused run of the 2-atom
    NC parity deck (tests/data/eigh_empty_rows_ssub.npy: 12 exactly zero
    rows beside 14 eigenvalues within 1.1e-9 of 1; ROADMAP queue 3, item 16)
    and a seeded Hermitian H with the same zero rows."""
    import numpy as np
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    s = np.load(os.path.join(here, "tests", "data", "eigh_empty_rows_ssub.npy"))
    rng = np.random.default_rng(seed)
    n = s.shape[0]
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = s @ (a + a.conj().T) @ s + s
    return torch.as_tensor(h)[None], torch.as_tensor(s)[None]


def check_eigh_empty_rows(dev, gpu: str) -> None:
    """The band solve's Rayleigh-Ritz on the card on the matrix cuSOLVER's
    heevd could not solve: solvers/davidson.py::_eigh retries it with
    cuSOLVER's Jacobi (kernels/eigh_jacobi.py), which must give the CPU's
    eigenvalues to 1e-12 of their scale, eigenvectors with |A V - V E| and
    |V^H V - I| below 1e-12, and the CPU's Ritz values to 1e-10. Whether
    heevd still fails on it is printed, not gated."""
    import torch

    from sirius_tpu_torch.kernels.eigh_jacobi import eigh_jacobi
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    h, s = empty_rows_pair()
    try:
        torch.linalg.eigh(s.to(dev))
        raw = "converged"
    except torch.linalg.LinAlgError as e:
        raw = str(e).splitlines()[0]
    launches = eigh_jacobi.launches
    e_j, v_j = eigh_jacobi(s.to(dev))
    e_lapack = torch.linalg.eigh(s)[0]
    scale = float(e_lapack.abs().max())
    eig_err = float((e_j.cpu() - e_lapack).abs().max())
    a_dev = s.to(dev)
    resid = float((a_dev @ v_j - v_j * e_j[..., None, :]).abs().max())
    ortho = float((v_j.mH @ v_j - torch.eye(
        v_j.shape[-1], dtype=v_j.dtype, device=dev)).abs().max())
    nev = 14
    e_dev, c_dev = _rayleigh_ritz(h.to(dev), a_dev, nev)
    e_cpu, _ = _rayleigh_ritz(h, s, nev)
    rr_err = float((e_dev.cpu() - e_cpu).abs().max())
    rr_scale = float(e_cpu.abs().max())
    emit({"phase": "eigh_empty_rows", "gpu": gpu,
          "empty_rows": int((s[0].abs().amax(-1) == 0).sum()),
          "raw_eigh": raw, "eig_err": eig_err, "scale": scale,
          "residual": resid, "orthonormality": ortho,
          "max_abs_err": rr_err, "rr_scale": rr_scale,
          "jacobi_launches": eigh_jacobi.launches - launches})
    if not (eig_err <= 1e-12 * scale and resid <= 1e-12 * scale
            and ortho <= 1e-12 and rr_err <= 1e-10 * rr_scale):
        raise AssertionError(
            f"eigh_empty_rows: eigenvalues {eig_err}, residual {resid}, "
            f"orthonormality {ortho}, Ritz values {rr_err} (scale {scale})")


@contextlib.contextmanager
def watch_band_solves():
    """Yield a list that collects, for every band solve run_scf makes, its
    precision ("fp32" where the solve returns float32 Ritz values) and the
    launches each kernel instantiation made during it (nonzero counts
    only). Wraps the solve functions dft/scf.py and dft/scf_nc.py call
    (davidson_kset, davidson_kset_mgga, davidson_gamma, the chunked path's
    davidson, davidson_kset_nc) and puts them back on exit."""
    import torch

    import sirius_tpu_torch.dft.scf as scf_mod
    import sirius_tpu_torch.dft.scf_nc as nc_mod

    solves = []
    saved = []
    for mod, names in ((scf_mod, ("davidson_kset", "davidson_kset_mgga",
                                  "davidson_gamma", "davidson")),
                       (nc_mod, ("davidson_kset_nc",))):
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def wrapped(*args, _fn=fn, **kwargs):
                before = read_launches()
                out = _fn(*args, **kwargs)
                after = read_launches()
                solves.append({
                    "precision": ("fp32" if out[0].dtype == torch.float32
                                  else "fp64"),
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}})
                return out

            setattr(mod, name, wrapped)
    try:
        yield solves
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def watch_forces_stress():
    """Yield a dict that collects, for the forces (dft/forces.py::
    total_forces) and the stress (dft/stress.py::StressCalculator.compute)
    run_scf computes, the launches each kernel made during them (nonzero
    counts only): the counters read just before and just after each."""
    import sirius_tpu_torch.dft.forces as forces_mod
    import sirius_tpu_torch.dft.stress as stress_mod

    seen: dict = {}
    total_forces = forces_mod.total_forces
    compute = stress_mod.StressCalculator.compute

    def counted(key, fn):
        def run(*args, **kwargs):
            before = read_launches()
            out = fn(*args, **kwargs)
            after = read_launches()
            seen[key] = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
            return out
        return run

    forces_mod.total_forces = counted("forces", total_forces)
    stress_mod.StressCalculator.compute = counted("stress", compute)
    try:
        yield seen
    finally:
        forces_mod.total_forces = total_forces
        stress_mod.StressCalculator.compute = compute


def check_forces(phase: str, dev, gpu: str, deck: str, res: dict, ref: dict,
                 seen: dict, required) -> None:
    """A force deck's forces and stress against the JAX package's record
    (FORCE_TOL, STRESS_TOL), printed beside the JAX package's own spread
    from perturbed starts; on the card the stress must have launched every
    kernel of required."""
    import numpy as np

    df = float(np.max(np.abs(np.subtract(res["forces"], ref["forces"]))))
    ds = float(np.max(np.abs(np.subtract(res["stress"], ref["stress"]))))
    emit({"phase": phase, "gpu": gpu, "deck": deck,
          "forces": res["forces"], "stress": res["stress"],
          "max_force_err": df, "force_tol": FORCE_TOL,
          "jax_force_spread": ref["forces_spread"],
          "max_stress_err": ds, "stress_tol": STRESS_TOL,
          "jax_stress_spread": ref["stress_spread"],
          "forces_seconds": res["forces_seconds"],
          "stress_seconds": res["stress_seconds"],
          "stress_term_seconds": res["stress_term_seconds"],
          "forces_launches": seen.get("forces", {}),
          "stress_launches": seen.get("stress", {})})
    if not df <= FORCE_TOL:
        raise AssertionError(f"{phase}: forces off by {df} > {FORCE_TOL} "
                             "Ha/bohr")
    if not ds <= STRESS_TOL:
        raise AssertionError(f"{phase}: stress off by {ds} > {STRESS_TOL} "
                             "Ha/bohr^3")
    check_stress_launched(phase, dev, seen, required)


def check_stress_launched(phase: str, dev, seen: dict, required) -> None:
    """On the card the stress's strained densities, gradients, XC and
    augmentation charge ran through their kernels."""
    if dev.type != "cuda":
        return
    got = seen.get("stress", {})
    zero = [k for k in required if got.get(k, 0) <= 0]
    if zero:
        raise AssertionError(f"{phase}: the stress never launched {zero}")


def check_band_solves(phase: str, dev, solves) -> None:
    """On the card, every fp32 band solve launched K2's fp32 instantiation
    and no fp64 band-solve kernel."""
    if dev.type != "cuda":
        return
    for i, solve in enumerate(solves):
        if solve["precision"] != "fp32":
            continue
        wide = {k: v for k, v in solve["launches"].items()
                if k in BAND_SOLVE_FP64}
        if wide:
            raise AssertionError(f"{phase}: fp32 band solve {i} launched fp64 "
                                 f"kernels: {wide}")
        if not any(solve["launches"].get(k) for k in
                   ("davidson_residual.c64", "davidson_residual.f32")):
            raise AssertionError(f"{phase}: fp32 band solve {i} launched no "
                                 "fp32 K2")


def moment_vector(mag: dict):
    """The total and per-atom moments of a result or record as one flat
    vector (components of a spinor run, z of a collinear one)."""
    import numpy as np

    return np.concatenate([np.ravel(mag["total"]), np.ravel(mag["atoms"])])


def iteration_span(rec: dict) -> list:
    """[least, most] iterations of the JAX package on a deck: its record's
    count and, where the reference tool recorded them, those of its runs
    from perturbed starts (perturbed_iterations)."""
    its = [rec["num_scf_iterations"]] + rec.get("perturbed_iterations", [])
    return [min(its), max(its)]


def check_iterations(phase: str, n: int, rec: dict) -> None:
    """A run's iteration count within +-1 of the JAX package's span."""
    lo, hi = iteration_span(rec)
    if not lo - 1 <= n <= hi + 1:
        raise AssertionError(f"{phase}: {n} iterations, the JAX package "
                             f"{lo} to {hi}")


def parity_scf_fp32(ctx, dev, refs: dict, name: str, gpu: str,
                    path: str | None = None, required=None) -> dict:
    """An fp32 deck of the reference tool against the JAX package's fp64
    twin of it (refs[refs[name]["twin"]]). With the fp32_to_fp64_rms polish
    every energy term and the electron count must land within 1e-8 of the
    twin, after at least one fp64 iteration, and the iteration count
    within +-1 of the JAX package's polished counts (iteration_span). In
    fp32 throughout (a fixed count) the total must land within 5e-5 Ha of
    the twin's, and every energy term, the electron count and (spinor; its
    6-op group pins the axis) every moment component within 4x the JAX
    package's own largest fp32-vs-fp64 gap in that quantity over its three
    fp32 runs of the deck (the record and two from starts perturbed by
    1e-7), the terms and moments at most 1e-4. The fp32 bands are
    S-normalized to fp32 rounding, so the electron count is off by ~1e-6 in
    the JAX package's own runs: it has no 1e-8 gate in fp32 throughout.
    Every fp32 band solve launched only fp32 band-solve kernels. path and
    required default to the deck's entry of FP32_DECK_PATH."""
    from sirius_tpu_torch.dft.scf import run_scf

    rec = refs[name]
    twin = refs[rec["twin"]]
    if path is None:
        path, required = FP32_DECK_PATH[name]
    phase = "parity_scf_" + name
    polished = ctx.cfg.settings.fp32_to_fp64_rms > 0
    reset_launches()
    with watch_band_solves() as solves:
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    terms = {k: res["energy"][k] - v for k, v in twin["energy"].items()}
    term_limit = 1e-8 if polished else min(4.0 * rec["twin_max_gap"], 1e-4)
    nel_limit = 1e-8 if polished else 4.0 * rec["twin_electron_gap"]
    out = {"phase": phase, "gpu": gpu, "deck": name, "twin": rec["twin"],
           "polished": polished,
           "num_scf_iterations": res["num_scf_iterations"],
           "ref_iterations": rec["num_scf_iterations"],
           "jax_iteration_span": iteration_span(rec),
           "twin_iterations": twin["num_scf_iterations"],
           "wf_precision": res["wf_precision"],
           "e_total": res["energy"]["total"], "d_total": terms["total"],
           "max_term_err": max(abs(v) for v in terms.values()),
           "term_limit": term_limit,
           "jax_twin_max_gap": rec["twin_max_gap"], "electrons": nel,
           "electron_limit": nel_limit,
           "iteration_seconds": res["iteration_seconds"],
           "band_solve_seconds": res["band_solve_seconds"],
           "band_solves": solves, "launches": launches}
    if "magnetisation" in twin:
        mom = float(abs(moment_vector(res["magnetisation"])
                        - moment_vector(twin["magnetisation"])).max())
        out.update(max_moment_err=mom,
                   moment_limit=min(4.0 * rec["twin_max_moment_gap"], 1e-4))
    emit(out)
    want_nel = twin["electrons"]
    if not abs(nel - want_nel) <= nel_limit:
        raise AssertionError(f"{phase}: electron count {nel}, want {want_nel} "
                             f"to {nel_limit}")
    bad = {k: v for k, v in terms.items() if abs(v) > term_limit}
    if bad:
        raise AssertionError(f"{phase}: energy terms off the fp64 twin by "
                             f"more than {term_limit} Ha: {bad}")
    prec = res["wf_precision"]
    if polished:
        check_iterations(phase, res["num_scf_iterations"], rec)
        if prec[0] != "fp32" or prec[-1] != "fp64":
            raise AssertionError(f"{phase}: no fp32 -> fp64 switch: {prec}")
    else:
        if abs(terms["total"]) > 5e-5:
            raise AssertionError(f"{phase}: |dE_total| {abs(terms['total'])}"
                                 " > 5e-5 Ha")
        if set(prec) != {"fp32"} or (res["num_scf_iterations"]
                                     != rec["num_scf_iterations"]):
            raise AssertionError(f"{phase}: {prec}, want "
                                 f"{rec['num_scf_iterations']} fp32 iterations")
        if "max_moment_err" in out and not (out["max_moment_err"]
                                            <= out["moment_limit"]):
            raise AssertionError(f"{phase}: moments off by "
                                 f"{out['max_moment_err']}")
    check_launched(phase, dev, launches, required, path,
                   res["num_scf_iterations"], ctx.num_mag_dims == 1)
    check_band_solves(phase, dev, solves)
    return launches


def parity_scf(ctx, dev, ref: dict, gpu: str, phase: str = "parity_scf",
               deck: str = "full_width_2atom", required=NC_KERNELS,
               path: str = "kset") -> dict:
    import numpy as np

    from sirius_tpu_torch.dft.scf import run_scf
    from sirius_tpu_torch.kernels.eigh_jacobi import eigh_jacobi

    reset_launches()
    retries = eigh_jacobi.launches
    with watch_forces_stress() as seen:
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    retries = eigh_jacobi.launches - retries
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    d_total = res["energy"]["total"] - ref["energy"]["total"]
    terms = {k: res["energy"][k] - v for k, v in ref["energy"].items()}
    emit({"phase": phase, "gpu": gpu, "deck": deck,
          "num_scf_iterations": res["num_scf_iterations"],
          "ref_iterations": ref["num_scf_iterations"],
          "jax_iteration_span": iteration_span(ref),
          "e_total": res["energy"]["total"], "d_total": d_total,
          "max_term_err": max(abs(v) for v in terms.values()),
          "efermi": res["efermi"], "efermi_err": res["efermi"] - ref["efermi"],
          "electrons": nel,
          "iteration_seconds": res["iteration_seconds"],
          "band_solve_seconds": res["band_solve_seconds"],
          "eigh_jacobi_retries": retries, "launches": launches})
    # the spinor records carry no electron count: the cell's valence count
    want_nel = ref.get("electrons", float(ctx.unit_cell.num_valence_electrons))
    if abs(nel - want_nel) > 1e-8:
        raise AssertionError(f"{phase}: electron count {nel}, want {want_nel}")
    if abs(d_total) > 1e-8:
        raise AssertionError(f"{phase}: |dE_total| = {abs(d_total)} > 1e-8 Ha")
    bad = {k: v for k, v in terms.items() if abs(v) > 1e-8}
    if bad:
        raise AssertionError(f"{phase}: energy terms off by > 1e-8 Ha: {bad}")
    check_iterations(phase, res["num_scf_iterations"], ref)
    polarized = "magnetisation" in ref
    if polarized and ref["deck"].get("so_correction"):
        err = float(np.max(np.abs(moment_vector(res["magnetisation"])
                                  - moment_vector(ref["magnetisation"]))))
        emit({"phase": phase, "gpu": gpu, "deck": deck,
              "total_moment": res["magnetisation"]["total"],
              "atom_moments": res["magnetisation"]["atoms"],
              "compared": "components (spin-orbit)",
              "max_moment_err": err, "moment_tol": SO_MOMENT_TOL,
              "jax_moment_spread": ref["moment_spread"],
              "jax_term_spread": ref["term_spread"]})
        if not err <= SO_MOMENT_TOL:
            raise AssertionError(f"{phase}: moments off by {err} > "
                                 f"{SO_MOMENT_TOL}")
    elif polarized and path == "kset_nc":
        got, want = res["magnetisation"], ref["magnetisation"]
        errs = spinor_moment_errors(got, want,
                                    bool(ctx.cfg.parameters.use_symmetry))
        emit({"phase": phase, "gpu": gpu, "deck": deck,
              "total_moment": got["total"], "atom_moments": got["atoms"],
              **errs})
        if not errs["max_moment_err"] <= errs["moment_tol"]:
            raise AssertionError(f"{phase}: moments off by "
                                 f"{errs['max_moment_err']} > "
                                 f"{errs['moment_tol']} ({errs['compared']})")
    elif polarized:
        got = res["magnetisation"]
        d_mag = max([abs(got["total"][2] - ref["magnetisation"]["total"])]
                    + [abs(a[2] - b) for a, b in zip(
                        got["atoms"], ref["magnetisation"]["atoms"])])
        emit({"phase": phase, "gpu": gpu, "deck": deck,
              "total_moment": got["total"][2],
              "atom_moments": [a[2] for a in got["atoms"]],
              "max_moment_err": d_mag})
        if not d_mag <= 1e-6:
            raise AssertionError(f"{phase}: moments off by {d_mag} > 1e-6")
    check_launched(phase, dev, launches, required, path,
                   res["num_scf_iterations"], polarized)
    if "forces" in ref:
        check_forces(phase, dev, gpu, deck, res, ref, seen,
                     FORCES_DECK_PATH[deck][2])
    return launches


# the moment limit of a non-magnetic spinor record: the JAX package's own
# runs of spinor_us and spinor_pbe_us_sym from start blocks perturbed by
# 1e-13 differ from their records by up to 3.49e-8 per component
# (tools/torch_port_reference.py --spread), ~3x that
NONMAGNETIC_MOMENT_TOL = 1e-7


def spinor_moment_errors(got: dict, want: dict, symmetric: bool) -> dict:
    """What the physics fixes of a non-collinear run's moments, and how far
    two runs differ in it. A magnetic state without a symmetry group has a
    zero mode (the functional has no spin-orbit term, so a common rotation
    of every moment costs no energy), and rounding turns its axis: there
    the magnitudes of the total and per-atom moments and the dot products
    between atoms are compared. A group that pins the axis makes the
    components themselves comparable. All at 1e-8. A state whose recorded
    total moment is below 1e-6 is not magnetic: its components are the
    rounding noise of spin-degenerate bands, compared at the spread of the
    JAX package's own runs (NONMAGNETIC_MOMENT_TOL)."""
    import numpy as np

    gt, wt = np.asarray(got["total"]), np.asarray(want["total"])
    ga, wa = np.asarray(got["atoms"]), np.asarray(want["atoms"])
    comp = float(max(np.max(np.abs(gt - wt)), np.max(np.abs(ga - wa))))
    if np.linalg.norm(wt) < 1e-6:
        return {"compared": "non-magnetic: components",
                "moment_tol": NONMAGNETIC_MOMENT_TOL,
                "max_moment_err": comp, "max_component_err": comp}
    inv = float(max(abs(np.linalg.norm(gt) - np.linalg.norm(wt)),
                    np.max(np.abs(np.linalg.norm(ga, axis=1)
                                  - np.linalg.norm(wa, axis=1))),
                    np.max(np.abs(ga @ ga.T - wa @ wa.T))))
    if symmetric:
        return {"compared": "components", "moment_tol": 1e-8,
                "max_moment_err": max(comp, inv), "max_component_err": comp}
    return {"compared": "magnitudes and dot products", "moment_tol": 1e-8,
            "max_moment_err": inv, "max_component_err": comp}


def full_width(ctx, dev, gpu: str, phase: str = "full_width",
               required=NC_KERNELS, deck: str = "si16_supercell2",
               path: str = "kset", with_result: bool = False,
               electron_tol: float = 1e-8):
    """One full-width run with tolerances that cannot be met, its electron
    count held to electron_tol. Returns the launches, and with with_result
    run_scf's result too."""
    import torch

    from sirius_tpu_torch.dft.scf import run_scf
    from sirius_tpu_torch.kernels.eigh_jacobi import eigh_jacobi

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    retries = eigh_jacobi.launches
    with watch_band_solves() as solves, watch_eigh() as eigh_calls:
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    retries = eigh_jacobi.launches - retries
    iters = res["num_scf_iterations"]
    prec = res["wf_precision"]
    secs = res["iteration_seconds"]
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    want_nel = float(ctx.unit_cell.num_valence_electrons)
    e_ok = all(math.isfinite(v) for v in res["energy"].values())
    emit({"phase": phase, "gpu": gpu, "deck": deck,
          "ultrasoft": ctx.aug is not None,
          "num_symmetry_ops": (0 if ctx.symmetry is None
                               else ctx.symmetry.num_ops),
          "num_bands": ctx.num_bands, "ngk_max": int(ctx.gkvec.ngk_max),
          "num_kpoints": ctx.gkvec.num_kpoints,
          "coarse_box": list(ctx.fft_coarse.dims),
          "fine_box": list(ctx.gvec.fft.dims), "num_gvec": ctx.gvec.num_gvec,
          "num_beta": ctx.beta.num_beta_total, "num_scf_iterations": iters,
          "iteration_seconds": res["iteration_seconds"],
          "rms_history": res["rms_history"],
          "fp32_to_fp64_rms": ctx.cfg.settings.fp32_to_fp64_rms,
          "band_solve_seconds": res["band_solve_seconds"],
          # after the first iteration, which carries the LCAO start
          "band_solve_share": (sum(res["band_solve_seconds"][1:])
                               / max(sum(res["iteration_seconds"][1:]), 1e-30)),
          "launches": launches,
          "launches_per_iteration": {k: v / iters for k, v in launches.items()},
          # the precision of each iteration's band solve, the seconds of the
          # fp32 and fp64 iterations after the first (which carries the LCAO
          # start), and each band solve's launches by instantiation
          "wf_precision": prec,
          "fp32_iteration_seconds": [t for i, (t, w) in enumerate(
              zip(secs, prec)) if i and w == "fp32"],
          "fp64_iteration_seconds": [t for i, (t, w) in enumerate(
              zip(secs, prec)) if i and w == "fp64"],
          "band_solves": solves, "eigh_calls": eigh_calls,
          "eigh_jacobi_retries": retries,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "electrons": nel, "electron_tol": electron_tol,
          "e_total": res["energy"]["total"],
          "total_moment": res.get("magnetisation", {}).get("total", [0.0] * 3),
          "energies_finite": e_ok})
    if iters != FULL_ITERS[phase]:
        raise AssertionError(f"{phase}: {iters} iterations, want "
                             f"{FULL_ITERS[phase]}")
    if not e_ok:
        raise AssertionError(f"{phase}: non-finite energy")
    if not abs(nel - want_nel) <= electron_tol:
        raise AssertionError(f"{phase}: electron count {nel}, want {want_nel}"
                             f" to {electron_tol}")
    check_launched(phase, dev, launches, required, path, iters,
                   ctx.num_mag_dims == 1)
    check_band_solves(phase, dev, solves)
    if phase == "full_width_us_fp32" and prec.count("fp32") not in (3, 4):
        raise AssertionError(f"{phase}: the polish switch fired after "
                             f"{prec.count('fp32')} fp32 iterations, want 3 "
                             "or 4")
    return (launches, res) if with_result else launches


def stress_card_vs_cpu(ctx, dev) -> dict:
    """Run ctx's SCF on dev with forces and stress on, take the state its
    run_scf hands dft/forces.py::total_forces and
    dft/stress.py::StressCalculator.compute, and feed it to both again on
    dev and on the CPU (the plain versions: the sigma form of the XC, the
    host rho_aug_g): the largest difference of each term, the result, and
    the kernels the stress launched on dev."""
    import numpy as np

    from sirius_tpu_torch.dft import forces as forces_mod
    from sirius_tpu_torch.dft import stress as stress_mod
    from sirius_tpu_torch.dft.scf import run_scf
    from sirius_tpu_torch.dft.xc import XCFunctional

    ctx.cfg.control.print_forces = True
    ctx.cfg.control.print_stress = True
    seen = {}
    compute = stress_mod.StressCalculator.compute
    total_forces = forces_mod.total_forces

    def stress_spy(self, *args, **kwargs):
        seen["stress"] = (args, kwargs)
        return compute(self, *args, **kwargs)

    def forces_spy(*args, **kwargs):
        seen["forces"] = (args, kwargs)
        return total_forces(*args, **kwargs)

    stress_mod.StressCalculator.compute = stress_spy
    forces_mod.total_forces = forces_spy
    try:
        with watch_forces_stress() as launches:
            res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    finally:
        stress_mod.StressCalculator.compute = compute
        forces_mod.total_forces = total_forces
    xc = XCFunctional(ctx.cfg.parameters.xc_functionals)
    args, kwargs = seen["stress"]
    on_cpu = list(args)
    on_cpu[2] = on_cpu[2].cpu()  # the bands
    want = stress_mod.StressCalculator(ctx, xc, device="cpu").compute(
        *on_cpu, **kwargs)
    got = stress_mod.StressCalculator(ctx, xc, device=dev).compute(
        *args, **kwargs)
    fargs, fkw = seen["forces"]
    f_cpu = list(fargs)
    f_cpu[5] = f_cpu[5].cpu()  # the bands
    f_want = total_forces(*f_cpu, **{k: v for k, v in fkw.items()
                                     if k != "beta"})
    f_got = total_forces(*fargs, **fkw)
    return {"stress_card_vs_cpu": {k: float(np.max(np.abs(got[k] - want[k])))
                                   for k in want},
            "forces_card_vs_cpu": {k: float(np.max(np.abs(f_got[k]
                                                          - f_want[k])))
                                   for k in f_want},
            "stress_launches": launches.get("stress", {}), "result": res}


# the stress's XC forms the force decks leave out, each on a small deck
# (gk 3 / pw 7, 2x2x2, 3 iterations, atom 1 moved along (111)): the card
# against the CPU on one state, every term to STRESS_FORM_TOL Ha/bohr^3,
# and the kernels each must launch
STRESS_FORM_TOL = 1e-10
STRESS_FORMS = {
    "pbe_us": (US_SYM, {"xc_functionals": PBE}, None,
               ("local_hpsi.pw_to_box", "gga_xc.pbe.unpolarized",
                "xc_gradient.gradient_boxes", "augmentation.rho_aug")),
    "pw92_us_afm": (US_SYM, {"xc_functionals": ["XC_LDA_X", "XC_LDA_C_PW"],
                             **SPIN}, AFM,
                    ("local_hpsi.pw_to_box", "lda_xc.pw92",
                     "augmentation.rho_aug")),
    "vwn_nc": (NC, {"xc_functionals": ["XC_LDA_X", "XC_LDA_C_VWN"]}, None,
               ("local_hpsi.pw_to_box", "lda_xc.vwn.unpolarized")),
}


def check_stress_forms(dev, gpu: str) -> None:
    """stress_card_vs_cpu on each deck of STRESS_FORMS."""
    import numpy as np

    from sirius_tpu_torch.testing import synthetic_silicon_context

    for name, (kind, params, moments, required) in STRESS_FORMS.items():
        ctx = synthetic_silicon_context(
            gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
            positions=np.array([[0.0, 0, 0], [0.26, 0.26, 0.26]]),
            moments=None if moments is None else np.asarray(moments),
            extra_params={"num_dft_iter": 3, **RUN_TO_END, **params},
            **kind)
        out = stress_card_vs_cpu(ctx, dev)
        res = out.pop("result")
        phase = "stress_form_" + name
        worst = max(out["stress_card_vs_cpu"].values())
        emit({"phase": phase, "gpu": gpu, **out, "tol": STRESS_FORM_TOL,
              "stress": res["stress"],
              "stress_seconds": res["stress_seconds"]})
        if not worst <= STRESS_FORM_TOL:
            raise AssertionError(f"{phase}: the card's stress is {worst} "
                                 f"from the CPU's > {STRESS_FORM_TOL}")
        worst_f = max(out["forces_card_vs_cpu"].values())
        if not worst_f <= STRESS_FORM_TOL:
            raise AssertionError(f"{phase}: the card's forces are {worst_f} "
                                 "from the CPU's")
        check_stress_launched(phase, dev, {"stress": out["stress_launches"]},
                              required)


def full_width_forces(dev, gpu: str, phase: str = "full_width_forces_us",
                      n: int = 2, spec: dict = FULL) -> dict:
    """The forces and stress at full width: the n x n x n ultrasoft cell
    with the space group that fixes atom 0 moved by FORCE_SHIFT, on the
    k-set solve, run to FORCE_SCF's tolerances with forces and stress on;
    then two SCFs with atom 0 at +-FORCE_FD_H bohr along Cartesian x, whose
    free energies give -dF/dx for F[0, 0] (FORCE_FD_TOL), and the net force
    (NET_FORCE_TOL). The stress must launch K1, K7 and K4 (the counters
    read just before and just after it). Returns the stress's launches."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.scf import band_solve_path, fuses, run_scf

    t_phase = time.perf_counter()

    def context(shift):
        return magnetic_supercell_context(
            n, spec, dict(FORCE_SCF), US_SYM, 0.0,
            displace=(0, np.asarray(FORCE_SHIFT) + shift))

    ctx = context(np.zeros(3))
    ctx.cfg.control.print_forces = True
    ctx.cfg.control.print_stress = True
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with watch_forces_stress() as seen:
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    dx = np.linalg.solve(ctx.unit_cell.lattice.T,
                         np.array([FORCE_FD_H, 0.0, 0.0]))
    free, iters = {}, {}
    for sign in (1, -1):
        c = context(sign * dx)
        r = run_scf(c.cfg, ctx=c, device=dev)
        free[sign], iters[sign] = r["energy"]["free"], r["num_scf_iterations"]
        if not r["converged"]:
            raise AssertionError(f"{phase}: the SCF at {sign:+d}h did not "
                                 "converge")
    f = np.asarray(res["forces"])
    sigma = np.asarray(res["stress"])
    f_fd = -(free[1] - free[-1]) / (2 * FORCE_FD_H)
    fd_err = abs(float(f[0, 0]) - f_fd)
    net = float(np.linalg.norm(f.sum(axis=0)))
    emit({"phase": phase, "gpu": gpu, "deck": f"si{2 * n ** 3}_us_sym_moved",
          "num_atoms": ctx.unit_cell.num_atoms,
          "num_symmetry_ops": (0 if ctx.symmetry is None
                               else ctx.symmetry.num_ops),
          "num_kpoints": ctx.gkvec.num_kpoints, "ngk_max": int(ctx.gkvec.ngk_max),
          "fine_box": list(ctx.gvec.fft.dims), "num_gvec": ctx.gvec.num_gvec,
          "band_solve": band_solve_path(ctx.cfg, ctx),
          "fused_d": fuses(ctx.cfg, ctx),
          "num_scf_iterations": res["num_scf_iterations"],
          "fd_iterations": [iters[1], iters[-1]],
          "iteration_seconds": res["iteration_seconds"],
          "forces_seconds": res["forces_seconds"],
          "stress_seconds": res["stress_seconds"],
          "stress_term_seconds": res["stress_term_seconds"],
          "max_memory_allocated": peak,
          "forces": res["forces"], "stress": res["stress"],
          "f00": float(f[0, 0]), "f00_finite_difference": f_fd,
          "fd_err": fd_err, "fd_tol": FORCE_FD_TOL, "net_force": net,
          "net_force_tol": NET_FORCE_TOL,
          "forces_launches": seen.get("forces", {}),
          "stress_launches": seen.get("stress", {}), "launches": launches,
          "phase_seconds": time.perf_counter() - t_phase})
    if not res["converged"]:
        raise AssertionError(f"{phase}: the SCF did not converge")
    if not (f.shape == (ctx.unit_cell.num_atoms, 3) and sigma.shape == (3, 3)
            and np.all(np.isfinite(f)) and np.all(np.isfinite(sigma))):
        raise AssertionError(f"{phase}: forces {f.shape}, stress "
                             f"{sigma.shape}, or not finite")
    if not fd_err <= FORCE_FD_TOL:
        raise AssertionError(f"{phase}: F[0, 0] {f[0, 0]} against "
                             f"-dF/dx {f_fd}: {fd_err} > {FORCE_FD_TOL}")
    if not net <= NET_FORCE_TOL:
        raise AssertionError(f"{phase}: net force {net} > {NET_FORCE_TOL}")
    check_launched(phase, dev, launches, US_KERNELS, "kset",
                   res["num_scf_iterations"])
    check_stress_launched(phase, dev, seen, STRESS_US_KERNELS)
    return seen.get("stress", {})


def xc_context(name: str):
    """The context of a 2-atom deck of XC_DECKS."""
    import numpy as np

    from sirius_tpu_torch.testing import synthetic_silicon_context

    spec, kind, params, moments = XC_DECKS[name]
    return synthetic_silicon_context(
        extra_params=dict(params), **kind, **spec,
        moments=None if moments is None else np.asarray(moments))


def magnetic_supercell_context(n: int, spec: dict, extra: dict, kind: dict,
                               moment, displace=None, atom_type=None):
    """The n x n x n supercell of the synthetic 2-atom cell with one
    starting moment on every atom: (0, 0, moment) for a number, else the
    vector (m_x, m_y, m_z). synthetic_silicon_context
    refuses moments with supercell > 1, so this tiles the positions and the
    moments itself, as that helper tiles positions, and builds the context
    the way the helper does. displace: (atom, fractional shift) moves one
    atom of the supercell off its site; atom_type replaces the synthetic
    species of kind["ultrasoft"]."""
    import numpy as np

    import sirius_tpu_torch.context as cm
    import sirius_tpu_torch.crystal.unit_cell as ucm
    from sirius_tpu_torch.config.schema import Config
    from sirius_tpu_torch.testing import synthetic_silicon_type

    params = {"gk_cutoff": spec["gk_cutoff"], "pw_cutoff": spec["pw_cutoff"],
              "ngridk": list(spec["ngridk"]),
              "use_symmetry": kind["use_symmetry"], "num_bands": -1,
              "xc_functionals": ["XC_LDA_X", "XC_LDA_C_PZ"],
              "smearing_width": 0.025, **extra}
    cfg = Config.from_dict({"parameters": params})
    lattice = 10.26 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]]) * n
    shifts = np.array([[i, j, k] for i in range(n) for j in range(n)
                       for k in range(n)], dtype=np.float64)
    base = np.array([[0.0, 0, 0], [0.25, 0.25, 0.25]])
    positions = ((base[None] + shifts[:, None]) / n).reshape(-1, 3)
    if displace is not None:
        positions[displace[0]] += np.asarray(displace[1], dtype=np.float64)
    vec = [0.0, 0.0, moment] if np.ndim(moment) == 0 else list(moment)
    moments = np.tile(np.asarray(vec, dtype=np.float64), (len(positions), 1))
    uc = ucm.UnitCell(
        lattice=lattice,
        atom_types=[atom_type or synthetic_silicon_type(
            ultrasoft=kind["ultrasoft"])],
        type_of_atom=np.zeros(len(positions), dtype=np.int32),
        positions=positions, moments=moments)
    orig = ucm.UnitCell.from_config
    try:
        ucm.UnitCell.from_config = staticmethod(lambda c, b=".": uc)
        return cm.SimulationContext.create(cfg, ".")
    finally:
        ucm.UnitCell.from_config = orig


def reference_tool():
    """tools/torch_port_reference.py, which defines the parity decks of the
    records (imported from its file: it loads no JAX until it runs one)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_port_reference.py")
    spec = importlib.util.spec_from_file_location("torch_port_reference",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def deck_context(name: str, tool=None):
    """The context of a deck of the reference tool (the spinor and fp32
    decks), with its control and settings entries applied."""
    import numpy as np

    from sirius_tpu_torch.testing import synthetic_silicon_context

    tool = tool or reference_tool()
    spec, kind, control, params, moments = tool.deck_spec(name)
    if name in tool.FILE_DECKS:
        # the spin-orbit decks: read from the deck and UPF species file the
        # tool writes, as the JAX package read them for the records
        import tempfile

        from sirius_tpu_torch.config.schema import load_config
        from sirius_tpu_torch.context import SimulationContext

        with tempfile.TemporaryDirectory() as tmp:
            path = tool.write_deck_files(name, tmp)
            ctx = SimulationContext.create(load_config(path), tmp)
    else:
        ctx = synthetic_silicon_context(
            extra_params=dict(params), **kind, **spec,
            moments=None if moments is None else np.asarray(moments))
    tool.apply_control(ctx.cfg, control)
    return ctx


def spin_orbit_supercell_context():
    """full_width_spinor_us's 16-atom cell (48 magnetic ops, 4 k-points, 84
    spinor bands) with the spin-orbit species (the l = 1 beta split into
    j = 1/2 and 3/2) and so_correction, for FULL_ITERS iterations."""
    from sirius_tpu_torch.crystal.atom_type import AtomType
    from sirius_tpu_torch.testing import synthetic_silicon_species

    species = AtomType.from_dict("Si", synthetic_silicon_species(
        ultrasoft=True, spin_orbit=True))
    return magnetic_supercell_context(
        2, FULL, {"num_dft_iter": FULL_ITERS["full_width_spinor_so_us"],
                  **RUN_TO_END, **NONCOLLINEAR, "so_correction": True},
        US_SYM, CANTED[0], atom_type=species)


def spin_orbit_host_step(ctx, dev, gpu: str) -> dict:
    """Time the host half of one spin-orbit iteration of dft/scf_nc.py at
    ctx's shapes: the screened D and the three B integrals to the host,
    SpinOrbitData.d_blocks there and the blocks back to the card, then the
    density matrix's rotate_dm there and back. Median of 7 after one warm
    call, on the perf_counter clock with the card idle."""
    import numpy as np
    import torch

    from sirius_tpu_torch.device import synchronize
    from sirius_tpu_torch.ops.so import SpinOrbitData

    so_data = SpinOrbitData.build(ctx)
    nbeta = ctx.beta.num_beta_total
    gen = torch.Generator(device=dev).manual_seed(17)

    def sym(scale):
        a = scale * torch.randn(nbeta, nbeta, generator=gen, device=dev,
                                dtype=torch.float64)
        return a + a.T

    dion = torch.as_tensor(np.asarray(ctx.beta.dion), device=dev)
    d0, db = dion + sym(0.1), [sym(0.05) for _ in range(3)]
    dm = torch.randn(3, nbeta, nbeta, generator=gen, device=dev,
                     dtype=torch.complex128)

    def d_step():
        out = so_data.d_blocks(d0.cpu().numpy(),
                               [d.cpu().numpy() for d in db])
        return torch.as_tensor(out, device=dev)

    def dm_step():
        return torch.as_tensor(so_data.rotate_dm(dm.cpu().numpy()),
                               device=dev)

    ms = {}
    for name, fn in (("d_blocks", d_step), ("rotate_dm", dm_step)):
        times = []
        for i in range(8):
            synchronize(dev)
            t0 = time.perf_counter()
            fn()
            synchronize(dev)
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        ms[name + "_ms"] = times[len(times) // 2]
    rec = {"phase": "spin_orbit_host_step", "gpu": gpu, "num_beta": nbeta,
           **ms}
    emit(rec)
    return rec


@contextlib.contextmanager
def working_directory(path: str):
    """Run the block in path (the entry points write output.json into the
    working directory), and its standard output into a buffer it yields."""
    import io

    cwd = os.getcwd()
    out = io.StringIO()
    os.chdir(path)
    try:
        with contextlib.redirect_stdout(out):
            yield out
    finally:
        os.chdir(cwd)


def entry_point_cli(dev, gpu: str, ref: dict) -> dict:
    """The sirius-scf-torch CLI on the card (cli.py::main, no --device: a
    deck without processing_unit runs on the GPU): the 2-atom ultrasoft +
    symmetry parity deck written with its species as UPF, --test_against
    an output.json made from that deck's JAX record. It must exit 0 and
    print TEST PASSED, every energy term of its output.json within 1e-8 Ha
    of the record, its iteration count within check_iterations' span, and
    every kernel of the k-set US path launched."""
    import tempfile

    from sirius_tpu_torch import cli
    from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                          synthetic_silicon_species,
                                          write_deck)

    phase = "entry_point_cli"
    with tempfile.TemporaryDirectory() as tmp:
        deck = synthetic_silicon_deck(**PARITY, use_symmetry=True,
                                      extra_params=TIGHT)
        path = write_deck(os.path.join(tmp, "deck"), deck,
                          synthetic_silicon_species(ultrasoft=True), "upf")
        ref_path = os.path.join(tmp, "output_ref.json")
        with open(ref_path, "w") as f:
            json.dump({"ground_state": {"energy": ref["energy"]}}, f)
        reset_launches()
        t0 = time.perf_counter()
        with working_directory(tmp) as out:
            rc = cli.main([path, "--test_against", ref_path])
        seconds = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(tmp, "output.json")) as f:
            gs = json.load(f)["ground_state"]
    terms = {k: gs["energy"][k] - v for k, v in ref["energy"].items()}
    passed = "TEST PASSED" in out.getvalue()
    emit({"phase": phase, "gpu": gpu, "deck": "full_width_2atom_us_sym",
          "species": "upf", "rc": rc, "test_passed": passed,
          "num_scf_iterations": gs["num_scf_iterations"],
          "ref_iterations": ref["num_scf_iterations"],
          "max_term_err": max(abs(v) for v in terms.values()),
          "device": gs["device"], "seconds": seconds,
          "scf_time": gs["scf_time"], "launches": launches})
    if rc != 0 or not passed:
        raise AssertionError(f"{phase}: exit {rc}, TEST PASSED printed: "
                             f"{passed}")
    bad = {k: v for k, v in terms.items() if abs(v) > 1e-8}
    if bad:
        raise AssertionError(f"{phase}: energy terms off by > 1e-8 Ha: {bad}")
    check_iterations(phase, gs["num_scf_iterations"], ref)
    check_launched(phase, dev, launches, US_KERNELS, "kset",
                   gs["num_scf_iterations"])
    return launches


def full_width_us_from_file(dev, gpu: str, want: dict) -> dict:
    """full_width_us's 16-atom cell written as a deck with UPF species and
    run through dft/scf.py::run_scf_from_file on the card: its energies and
    iteration count must be bit for bit those of the in-memory run (want,
    run_scf's result), so the UPF route rebuilds the species exactly."""
    import tempfile

    from sirius_tpu_torch.dft.scf import run_scf_from_file
    from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                          synthetic_silicon_species,
                                          write_deck)

    phase = "full_width_us_from_file"
    with tempfile.TemporaryDirectory() as tmp:
        deck = synthetic_silicon_deck(
            **FULL, use_symmetry=True,
            extra_params={"num_dft_iter": FULL_ITERS["full_width_us"],
                          **RUN_TO_END})
        path = write_deck(os.path.join(tmp, "deck"), deck,
                          synthetic_silicon_species(ultrasoft=True), "upf")
        reset_launches()
        t0 = time.perf_counter()
        with working_directory(tmp):
            rc = run_scf_from_file(path, device=dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(tmp, "output.json")) as f:
            gs = json.load(f)["ground_state"]
    same = (gs["energy"] == want["energy"]
            and gs["num_scf_iterations"] == want["num_scf_iterations"])
    iters = gs["num_scf_iterations"]
    emit({"phase": phase, "gpu": gpu, "deck": "si16_supercell2_us_sym",
          "species": "upf", "rc": rc, "num_scf_iterations": iters,
          "bitwise_in_memory": same, "e_total": gs["energy"]["total"],
          "d_total": gs["energy"]["total"] - want["energy"]["total"],
          "seconds": seconds, "scf_time": gs["scf_time"],
          "iteration_seconds": gs["iteration_seconds"],
          "in_memory_iteration_seconds": want["iteration_seconds"],
          "launches": launches})
    if rc != 0 or not same:
        raise AssertionError(f"{phase}: exit {rc}; not bit for bit the "
                             "in-memory full_width_us run")
    check_launched(phase, dev, launches, US_KERNELS, "kset", iters)
    return launches


def single_k_context(name: str, spec: dict = GAMMA2):
    """The context of a 2-atom single-k parity deck (SINGLE_K)."""
    kind, params, control = SINGLE_K[name]
    ctx = make_context(spec, params, kind)
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    return ctx


# ---------------------------------------------------------------------------
# The fused step (dft/fused.py): K13 (fermi), K14a / K14b (mixer.gram,
# mixer.update) and K15 (scf_record), the per-iteration records of the two
# fused decks against the JAX package's, the step from K13 to the record
# read without a host sync, and the same-call A/B of device_scf auto
# against off.
# ---------------------------------------------------------------------------

SMEARINGS = ("gaussian", "fermi_dirac", "cold", "methfessel_paxton")
# the mixer's history depth at full width (the decks' max_history 8), and
# the oldest slot of the wrapped ring the records use
MIXER_M = 8
MIXER_HEAD = 3
# the record slots that hold energies (vha .. eval_sum), and the ledger's
FUSED_ENERGY_SLOTS = tuple(range(2, 11))
FUSED_LEDGER_SLOTS = (16, 17, 18, 19)
# a fused deck's records against the JAX package's: at every iteration
# both ran, each energy slot and rms within FUSED_RECORD_TOL. The records
# of two correct runs differ by where each Davidson stops at its loose
# early tolerance (the port and the JAX package on the CPU by up to 3.6e-8
# Ha at iteration 2 of the small US deck; cuSOLVER's subspaces on the card
# move that further); the converged state is held by the energy terms'
# 1e-8 Ha, as in every parity gate
FUSED_RECORD_TOL = 1e-6


def fermi_inputs(rng, shape, dev, case: str = "deck"):
    """(evals, kweights, nel, width) of K13 at a deck's [nk, ns, nb]:
    seeded evals over 1.3 Ha, the 16-atom cells' 64 electrons at max
    occupancy 2 for 'deck'; every band full ('full'); a threefold level
    half filled at mu ('degenerate')."""
    import numpy as np
    import torch

    nk, ns, nb = shape
    kw = rng.uniform(0.5, 1.5, nk)
    kw /= kw.sum()
    ev = np.sort(rng.uniform(-0.5, 0.8, shape), axis=-1)
    nel = min(64.0, 2.0 * ns * nb - 4.0)
    if case == "full":
        nel = 2.0 * ns * nb
    elif case == "degenerate":
        # k full bands below 0.1, the level at 0.25, the rest above 0.5
        k = nb // 2 - 2
        ev[..., :k] = np.sort(rng.uniform(-0.5, 0.1, (nk, ns, k)), axis=-1)
        ev[..., k:k + 3] = 0.25
        ev[..., k + 3:] = np.sort(rng.uniform(0.5, 0.8, (nk, ns, nb - k - 3)),
                                  axis=-1)
        nel = 2.0 * ns * (k + 1.5)
    return (torch.as_tensor(ev, device=dev), torch.as_tensor(kw, device=dev),
            nel, 0.025)


def fermi_record(out, deck, gpu, name, ev, kw, nel, width, kind, time=True):
    """K13 against its plain version on the card: mu to 1e-12 Ha, occ and
    the entropy to 1e-12 relative (record_kernel), or, where every band is
    full, occ and the entropy alone: for the Gaussian and Fermi-Dirac kinds
    mu then lies on a plateau of the count, where the two sums' rounding
    decides how far up the bisection goes (mu_abs_err is printed)."""
    from sirius_tpu_torch.kernels import fermi as k13

    args = (ev, kw, nel, width, kind, 2.0)
    got = k13.find_fermi(*args)
    want = k13.find_fermi_plain(*args)
    mu_err = abs(float(got[0]) - float(want[0]))
    full = nel >= 2.0 * ev.shape[1] * ev.shape[2]
    n = ev.numel()
    extra = {"kind": kind, "shape": list(ev.shape), "nel": nel,
             "mu": float(got[0]), "mu_plain": float(want[0]),
             "mu_abs_err": mu_err, "mu_tol": 1e-12,
             # 80 dependent steps: one block, latency-bound
             "latency_bound_ms": 80 * 5e-6}
    if time:
        record_kernel(out, deck, gpu, name, [got[1], got[2]],
                      [want[1], want[2]], lambda: k13.find_fermi(*args),
                      lambda: k13.find_fermi_plain(*args), None,
                      # evals and weights read, occ written, mu and ent
                      16.0 * n + 16.0, 80.0 * 25.0 * n + 50.0 * n,
                      slow_plain=True, extra=extra)
    else:
        errs = [rel_err(a, b) for a, b in ((got[1], want[1]),
                                           (got[2], want[2]))]
        rel = max(e[1] for e in errs)
        emit({"phase": "kernel_edges", "gpu": gpu, "name": name,
              "max_rel_err": rel, "tol_rel": TOL["fermi"], **extra})
        if not rel <= TOL["fermi"]:
            raise AssertionError(f"{name}: rel err {rel}")
    if not (full or mu_err <= 1e-12):
        raise AssertionError(f"{name}: mu off by {mu_err} Ha")


def mixer_inputs(rng, nx: int, ng: int, dev, count: int, head: int,
                 poison: str = "", m: int = MIXER_M):
    """A ring of m rows holding `count` seeded pairs (the oldest at
    `head`), x_in, x_new and the metric; poison puts a NaN in a residual
    row ('gram') or in x_new ('x_new')."""
    import numpy as np
    import torch

    def c(*shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape), device=dev)

    x_in = c(nx)
    x_new = x_in + 0.05 * c(nx)
    hx = torch.zeros((m, nx), dtype=torch.complex128, device=dev)
    hf = torch.zeros_like(hx)
    for i in range(count):
        slot = (head + i) % m
        hx[slot] = x_in + 0.1 * c(nx)
        hf[slot] = 0.05 * c(nx)
    if poison == "gram":
        hf[(head + 1) % m, 7] = complex(float("nan"), 0.0)
    elif poison == "x_new":
        x_new[11] = complex(float("nan"), 0.0)
    g2 = torch.as_tensor(np.sort(rng.uniform(0.0, 30.0, ng)), device=dev)
    g2[0] = 0.0
    w = torch.where(g2 > 0, 4 * math.pi / g2, torch.zeros_like(g2))
    w = torch.cat([w, torch.full((nx - ng,), 270.0, device=dev,
                                 dtype=torch.float64)])
    rms_w = torch.ones(nx, dtype=torch.float64, device=dev)
    eha_w = torch.where(g2 > 0, 2 * math.pi * 270.0 / g2,
                        torch.zeros_like(g2))
    return hx, hf, x_in, x_new, w, rms_w, eha_w


def mixer_records(out, deck, gpu, nx, ng, dev, rng, count, head, poison="",
                  time=True, m=MIXER_M):
    """K14a and K14b against their plain versions on one ring state; K14b
    from the same system for both (the plain K14a's), each on its own copy
    of the ring, which it pushes into. Holds x_mixed, rms and eha to 1e-12
    relative with NaN where the plain version has them, and the same
    choice of the damped fallback."""
    import torch

    from sirius_tpu_torch.kernels import mixer as k14

    hx, hf, x_in, x_new, w, rms_w, eha_w = mixer_inputs(
        rng, nx, ng, dev, count, head, poison, m)
    push = k14.push_slot(count, head, m)
    sys_k = k14.mixer_gram(hf, count, head, x_in, x_new, w, rms_w)
    sys_p = k14.mixer_gram_plain(hf, count, head, x_in, x_new, w, rms_w)
    rings = [(hx.clone(), hf.clone()) for _ in range(2)]
    xk, ehak = k14.mixer_update(*rings[0], sys_p, count, head, push, x_in,
                                x_new, eha_w, 0.6)
    xp, ehap = k14.mixer_update_plain(*rings[1], sys_p, count, head, push,
                                      x_in, x_new, eha_w, 0.6)
    nan_k = torch.isnan(torch.view_as_real(xk))
    nan_p = torch.isnan(torch.view_as_real(xp))
    same_nan = bool(torch.equal(nan_k, nan_p))
    damped = x_in + 0.6 * (x_new - x_in)
    fb_k = bool(torch.equal(torch.view_as_real(xk).nan_to_num(),
                            torch.view_as_real(damped).nan_to_num()))
    fb_p = bool(torch.equal(torch.view_as_real(xp).nan_to_num(),
                            torch.view_as_real(damped).nan_to_num()))
    pushed = all(bits_equal(a, b) for a, b in zip(rings[0], rings[1]))
    fin = ~nan_p
    ek = torch.view_as_real(xk)[fin]
    ep = torch.view_as_real(xp)[fin]
    finite_sys = bool(torch.all(torch.isfinite(sys_p)))
    tag = f"m {m}, count {count}, head {head}" + (
        f", NaN in {poison}" if poison else "")
    extra = {"m": m, "count": count, "head": head, "poison": poison, "nx": nx,
             "same_nan": same_nan, "fallback": fb_k, "fallback_plain": fb_p,
             "ring_push_equal": pushed}
    if not (same_nan and fb_k == fb_p and pushed):
        raise AssertionError(f"mixer at {tag}: NaN {same_nan}, fallback "
                             f"{fb_k} / {fb_p}, push {pushed}")
    if not time:
        # the system and the update at the edge, then the rms and eha
        errs = ([rel_err(sys_k, sys_p)] if finite_sys else []) + [
            rel_err(ek, ep)]
        ehas = (float(ehak), float(ehap))
        eha_ok = (all(math.isnan(v) for v in ehas)
                  or abs(ehas[0] - ehas[1]) <= 1e-12 * abs(ehas[1]))
        rel = max(e[1] for e in errs)
        emit({"phase": "kernel_edges", "gpu": gpu, "name": "mixer",
              "case": tag, "max_rel_err": rel, "eha": ehas, **extra})
        if not (rel <= TOL["mixer.update"] and eha_ok):
            raise AssertionError(f"mixer at {tag}: rel err {rel}, eha "
                                 f"{ehas}")
        return
    rows = count
    record_kernel(
        out, deck, gpu, "mixer.gram", [sys_k], [sys_p],
        lambda: k14.mixer_gram(hf, count, head, x_in, x_new, w, rms_w),
        lambda: k14.mixer_gram_plain(hf, count, head, x_in, x_new, w, rms_w),
        # the host Gram product of the port's Mixer._mix_anderson
        lambda: ((hf[:rows].conj() * w) @ hf[:rows].mT),
        # x_in, x_new, rows of hf (16 B) and w, rms_w (8 B); the sums
        nx * (32.0 + 16.0 * rows + 16.0) + 8.0 * (m * m + m + 1),
        nx * 4.0 * (rows * (rows + 1) / 2 + rows + 1), extra=extra)
    ring = (hx.clone(), hf.clone())
    record_kernel(
        out, deck, gpu, "mixer.update", [ek, ehak], [ep, ehap],
        lambda: k14.mixer_update(*ring, sys_p, count, head, push, x_in, x_new,
                                 eha_w, 0.6),
        lambda: k14.mixer_update_plain(*ring, sys_p, count, head, push, x_in,
                                       x_new, eha_w, 0.6), None,
        # x_in, x_new and 2 rows a pair read, x_mixed and the pushed pair
        # written, eha_w read; two passes' sums
        nx * (32.0 + 32.0 * rows + 16.0 + 32.0) + 8.0 * ng,
        nx * (8.0 * rows + 8.0) + 8.0 * ng,
        extra={**extra, "latency_bound_ms": 5 * 5e-6})


def record_inputs(rng, dev, box, ng: int, nk: int, ns: int, nb: int,
                  poison: bool = False):
    """Segments of K15 shaped as the fused step's at a deck: six energy
    dot products over the fine box, four Harris terms over the G set,
    eval_sum, the copies, the finiteness of x, veff and the evals, the
    ledger's matrices and the symmetry difference; poison puts a NaN into
    veff (S_FINITE must read 0)."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels.scf_record import Segment

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    def c(*shape):
        return torch.complex(r(*shape), r(*shape))

    n = int(np.prod(box))
    scale = 270.0 / n
    rho = c(ng)
    veff = c(ng)
    if poison:
        veff[5] = complex(float("nan"), 0.0)
    gram = torch.eye(nb, dtype=torch.complex128, device=dev) + 1e-15 * c(
        nk, ns, nb, nb)
    ev = r(nk, ns, nb)
    segs = [Segment("sum", 0, r(1)), Segment("sum", 1, r(1))]
    segs += [Segment("dot", slot, r(n), r(n), scale=scale)
             for slot in range(2, 8)]
    segs += [Segment("dot_c", 8, rho, c(ng), scale=270.0),
             Segment("dot_c", 9, rho, veff, scale=270.0),
             Segment("dot_c", 8, rho, c(ng), scale=270.0),
             Segment("dot_c", 9, rho, c(ng), scale=270.0),
             Segment("dot", 10, r(nk * ns * nb), ev.view(-1)),
             Segment("sum", 11, r(1), scale=270.0),
             Segment("sum", 12, r(1), scale=270.0),
             Segment("sum", 13, r(1)), Segment("sum", 14, r(1)),
             Segment("finite", 15, r(2 * ng)),
             Segment("finite", 15, torch.view_as_real(veff).reshape(-1)),
             Segment("finite", 15, ev.view(-1)),
             Segment("eye", 16, gram, param=nb),
             Segment("maxabs", 17, r(1), r(1), scale=270.0),
             Segment("maxabs_c", 18, rho + 1e-14 * c(ng), rho),
             Segment("herm", 19, gram, param=nb)]
    nbytes = sum(8.0 * s.a.numel() * (2 if s.a.is_complex() else 1)
                 * (1 if s.b is None else 2) for s in segs) + 8.0 * 20
    return segs, nbytes


def record_check(out, deck, gpu, dev, rng, box, ng, nk, ns, nb,
                 poison=False):
    """K15 against its plain version: every slot within 1e-12 relative of
    its own magnitude, S_FINITE 0 where veff holds a NaN."""
    import torch

    from sirius_tpu_torch.kernels import scf_record as k15

    segs, nbytes = record_inputs(rng, dev, box, ng, nk, ns, nb, poison)
    got = k15.scf_record(segs, 20)
    want = k15.scf_record_plain(segs, 20)
    # NaN where the plain version has one (the poisoned E2), each other
    # slot against its own magnitude
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError("scf_record: NaN slots differ from the plain "
                             "version's")
    slot_rel = float(torch.max(((got - want).abs()
                                / want.abs().clamp(min=1e-300))[~nan]))
    extra = {"slot_max_rel_err": slot_rel, "segments": len(segs),
             "finite": float(got[15]), "finite_plain": float(want[15]),
             "poison": poison}
    if poison:
        emit({"phase": "kernel_edges", "gpu": gpu, "name": "scf_record",
              **extra})
    else:
        record_kernel(out, deck, gpu, "scf_record", [got], [want],
                      lambda: k15.scf_record(segs, 20),
                      lambda: k15.scf_record_plain(segs, 20), None,
                      nbytes, nbytes / 8.0 * 2.0, extra=extra)
    if not (slot_rel <= TOL["scf_record"]
            and float(got[15]) == (0.0 if poison else 1.0)
            and float(want[15]) == float(got[15])):
        raise AssertionError(f"scf_record: slot rel err {slot_rel}, "
                             f"S_FINITE {float(got[15])}")


def check_fused_kernels(deck: str, ctx, dev, gpu: str) -> dict:
    """K13, K14a, K14b and K15 at a full-width deck's shapes (records),
    then their edge cases: K13 for each smearing kind, every band full and
    a level degenerate at mu; K14 at counts 0 and 3, the wrapped ring, a
    64-row ring, a NaN in a residual row (a not finite) and in x_new (the
    damped fallback); K15 with a NaN in veff."""
    import numpy as np

    from sirius_tpu_torch.kernels import mixer as k14

    rng = np.random.default_rng(47)
    nk, ns, nb = ctx.gkvec.num_kpoints, ctx.num_spins, ctx.num_bands
    ng = ctx.gvec.num_gvec
    box = tuple(ctx.gvec.fft.dims)
    out = {}
    ev, kw, nel, width = fermi_inputs(rng, (nk, ns, nb), dev)
    fermi_record(out, deck, gpu, "fermi", ev, kw, nel, width, "gaussian")
    mixer_records(out, deck, gpu, ng, ng, dev, rng, MIXER_M, MIXER_HEAD)
    record_check(out, deck, gpu, dev, rng, box, ng, nk, ns, nb)
    for kind in SMEARINGS:
        for case in ("deck", "full", "degenerate"):
            ev, kw, nel, width = fermi_inputs(rng, (nk, ns, nb), dev, case)
            fermi_record(out, deck, gpu, f"fermi.{kind}.{case}", ev, kw, nel,
                         width, kind, time=False)
    for count, head, poison, m in ((0, 0, "", MIXER_M), (3, 0, "", MIXER_M),
                                   (MIXER_M, 5, "", MIXER_M),
                                   (MIXER_M, MIXER_HEAD, "gram", MIXER_M),
                                   (3, 0, "x_new", MIXER_M),
                                   # the deepest history the solve takes,
                                   # its matrices past 48 KB of shared memory
                                   (k14.MAX_HISTORY, 17, "",
                                    k14.MAX_HISTORY)):
        mixer_records(out, deck, gpu, 2 * 1009, 1009, dev, rng, count, head,
                      poison, time=False, m=m)
    record_check(out, deck, gpu, dev, rng, (7, 11, 13), 1009, 2, 2, 5,
                 poison=True)
    return out


@contextlib.contextmanager
def sync_free_step():
    """Run the fused step from K13 to the record read under
    torch.cuda.set_sync_debug_mode("error"): any host sync in between
    raises. Yields the count of guarded steps."""
    import torch

    from sirius_tpu_torch.dft import scf as scf_mod

    fermi, read = scf_mod.find_fermi, scf_mod.read_record
    steps = {"guarded": 0}

    def guarded_fermi(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        return fermi(*args, **kwargs)

    def guarded_read(record):
        torch.cuda.set_sync_debug_mode(0)
        steps["guarded"] += 1
        return read(record)

    scf_mod.find_fermi, scf_mod.read_record = guarded_fermi, guarded_read
    try:
        yield steps
    finally:
        torch.cuda.set_sync_debug_mode(0)
        scf_mod.find_fermi, scf_mod.read_record = fermi, read


def parity_fused_record(dev, gpu: str, refs: dict, tool) -> dict:
    """The reference tool's FUSED_DECKS on the card, the step from K13 to
    the record read sync-free (sync_free_step): the per-iteration records
    against the JAX package's (every energy slot and rms within
    FUSED_RECORD_TOL at each iteration both ran, the finite flag 1, the
    electron count within 1e-8, the ledger below 1e-10), the iteration
    count within +-1, the energy terms within 1e-8 Ha, moments within
    1e-6, the fused kernels launched."""
    import numpy as np

    from sirius_tpu_torch.dft.scf import run_scf

    runs = {}
    for name in tool.FUSED_DECKS:
        ref = refs[name]
        ctx = deck_context(name, tool)
        phase = "parity_fused_record_" + name.removeprefix("fused_")
        reset_launches()
        try:
            with sync_free_step() as steps:
                res = run_scf(ctx.cfg, ctx=ctx, device=dev)
        except RuntimeError as exc:
            emit({"phase": phase, "gpu": gpu, "sync_free": False,
                  "error": str(exc)[:400]})
            raise
        launches = read_launches()
        got = np.array(res["scf_scalars"])
        want = np.array(ref["scf_scalars"])
        n = min(len(got), len(want))
        gap = np.abs(got[:n] - want[:n])
        slots = list(FUSED_ENERGY_SLOTS) + [0]
        per_it = [float(gap[i, slots].max()) for i in range(n)]
        terms = {k: res["energy"][k] - v for k, v in ref["energy"].items()}
        nel = float(ctx.unit_cell.num_valence_electrons)
        emit({"phase": phase, "gpu": gpu, "deck": name, "sync_free": True,
              "guarded_steps": steps["guarded"],
              "num_scf_iterations": res["num_scf_iterations"],
              "ref_iterations": ref["num_scf_iterations"],
              "max_slot_gap_per_iteration": per_it,
              "max_term_err": max(abs(v) for v in terms.values()),
              "max_nel_err": float(np.max(np.abs(got[:, 11] - nel))),
              "ledger_max": got[:, list(FUSED_LEDGER_SLOTS)].max(
                  axis=0).tolist(),
              "iteration_seconds": res["iteration_seconds"],
              "launches": launches})
        if steps["guarded"] != res["num_scf_iterations"]:
            raise AssertionError(f"{phase}: {steps['guarded']} guarded steps "
                                 f"in {res['num_scf_iterations']} iterations")
        if not max(per_it) <= FUSED_RECORD_TOL:
            raise AssertionError(f"{phase}: record slots off by "
                                 f"{max(per_it)}")
        if not (np.all(got[:, 15] == 1.0)
                and np.max(np.abs(got[:, 11] - nel)) <= 1e-8
                and got[:, list(FUSED_LEDGER_SLOTS)].max() < 1e-10):
            raise AssertionError(f"{phase}: finite / electrons / ledger off")
        bad = {k: v for k, v in terms.items() if abs(v) > 1e-8}
        if bad:
            raise AssertionError(f"{phase}: energy terms off: {bad}")
        check_iterations(phase, res["num_scf_iterations"], ref)
        if "magnetisation" in ref:
            d_mag = abs(res["magnetisation"]["total"][2]
                        - ref["magnetisation"]["total"])
            if not d_mag <= 1e-6:
                raise AssertionError(f"{phase}: moment off by {d_mag}")
        required = (US_FUSED if ctx.num_mag_dims == 0 else
                    xc_kernels(US_FUSED, False, True, lda_set="lda_xc.pw92",
                               polarized=True))
        check_launched(phase, dev, launches, required)
        runs[name] = launches
    return runs


def count_syncs(run):
    """(result, host syncs) of run() under set_sync_debug_mode("warn")."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) for w in caught)


def fused_ab(ctx, dev, gpu: str, phase: str = "fused_ab_us") -> dict:
    """device_scf auto against off on one deck in one call, in turns (off,
    auto, auto, off): seconds an iteration after the first, bit-level
    agreement of the energies; then one run of each under the sync
    counter, and one of auto with control.scf_supervision off: host syncs
    an iteration (the supervisor's snapshot reads are the difference)."""
    from sirius_tpu_torch.dft.scf import run_scf

    secs = {"auto": [], "off": []}
    energies = {}
    for mode in ("off", "auto", "auto", "off"):
        ctx.cfg.control.device_scf = mode
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
        secs[mode].append(res["iteration_seconds"][1:])
        energies[mode] = res["energy"]["total"]
    syncs = {}
    for mode in ("off", "auto", "auto_unsupervised"):
        ctx.cfg.control.device_scf = mode.split("_")[0]
        ctx.cfg.control.scf_supervision = mode != "auto_unsupervised"
        res, n = count_syncs(lambda: run_scf(ctx.cfg, ctx=ctx, device=dev))
        syncs[mode] = n / res["num_scf_iterations"]
    ctx.cfg.control.device_scf = "auto"
    ctx.cfg.control.scf_supervision = True
    rec = {"phase": phase, "gpu": gpu, "order": ["off", "auto", "auto", "off"],
           "iteration_seconds": secs,
           "mean_s_per_iteration": {m: sum(map(sum, v)) / sum(map(len, v))
                                    for m, v in secs.items()},
           "syncs_per_iteration": syncs,
           "e_total_gap": energies["auto"] - energies["off"]}
    emit(rec)
    if not abs(rec["e_total_gap"]) <= 1e-8:
        raise AssertionError(f"{phase}: auto and off differ by "
                             f"{rec['e_total_gap']} Ha")
    return rec


def check_density_hdiag_kernels(deck: str, ctx, dev, gpu: str) -> dict:
    """K16a, K16b and K18 against their plain versions at a full-width
    deck's shapes (records; each must be bit for bit its plain version),
    and the whole density_scatter (K16a, cuFFT, K16b) against
    density_scatter_plain on the card, bit for bit."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import density_scatter as k16
    from sirius_tpu_torch.kernels import h_diag as k18

    rng = np.random.default_rng(53)
    out = {}
    ns, ng = ctx.num_spins, ctx.gvec.num_gvec
    dims = tuple(ctx.fft_coarse.dims)
    omega = float(ctx.unit_cell.omega)
    table = torch.as_tensor(k16.fine_to_coarse_box(
        ctx.gvec_coarse.fft_index, ctx.coarse_to_fine, ng), device=dev)
    acc = torch.as_tensor(rng.random((ns,) + dims), device=dev)
    n = acc.numel()
    box_k = k16.coarse_box(acc, omega)
    box_p = k16.coarse_box_plain(acc, omega)
    record_kernel(out, deck, gpu, "density_scatter.coarse_box", [box_k],
                  [box_p], lambda: k16.coarse_box(acc, omega),
                  lambda: k16.coarse_box_plain(acc, omega), None,
                  n * (8 + 16), n,
                  extra={"bitwise": bits_equal(box_k, box_p)})
    boxg = torch.fft.fftn(box_k, dim=(-3, -2, -1),
                          norm="forward").reshape(ns, -1)
    sc_k = k16.scatter_fine(boxg, table, ng)
    sc_p = k16.scatter_fine_plain(boxg, table, ng)
    n_in = int((table >= 0).sum())
    record_kernel(out, deck, gpu, "density_scatter.scatter_fine", [sc_k],
                  [sc_p], lambda: k16.scatter_fine(boxg, table, ng),
                  lambda: k16.scatter_fine_plain(boxg, table, ng), None,
                  4 * ng + 16 * ns * n_in + 16 * ns * ng, 0.0,
                  extra={"bitwise": bits_equal(sc_k, sc_p),
                         "coarse_in_fine": n_in})
    whole = bits_equal(k16.density_scatter(acc, omega, table, ng),
                       k16.density_scatter_plain(acc, omega, table, ng))
    # K18 at the deck's k-set: its projectors, a symmetric D per spin
    nk, ngk = ctx.gkvec.num_kpoints, ctx.gkvec.ngk_max
    nbeta = ctx.beta.num_beta_total
    mask = torch.as_tensor(np.asarray(ctx.gkvec.mask, dtype=np.float64),
                           device=dev)
    ekin = torch.as_tensor(np.asarray(ctx.gkvec.kinetic()), device=dev)
    beta = torch.as_tensor(ctx.beta.beta_gk, device=dev) * mask[:, None, :]
    d = rng.standard_normal((ns, nbeta, nbeta))
    d = torch.as_tensor(d + d.transpose(0, 2, 1), device=dev)
    q = torch.einsum("kxg,sxy,kyg->ksg", beta.conj(), d.to(beta.dtype), beta)
    v0 = torch.as_tensor(rng.standard_normal(1), device=dev)[0]
    h_k = k18.h_diag_pass(ekin, mask, q, v0, ns)
    h_p = k18.h_diag_pass_plain(ekin, mask, q, v0, ns)
    m = nk * ns * ngk
    record_kernel(out, deck, gpu, "h_diag", [h_k], [h_p],
                  lambda: k18.h_diag_pass(ekin, mask, q, v0, ns),
                  lambda: k18.h_diag_pass_plain(ekin, mask, q, v0, ns), None,
                  2 * 8 * nk * ngk + 16 * m + 8 * m, 2 * m,
                  extra={"bitwise": bits_equal(h_k, h_p)})
    emit({"phase": "density_scatter_whole", "deck": deck, "gpu": gpu,
          "bitwise": whole})
    bad = [k for k, r in out.items() if not r["bitwise"]] + (
        [] if whole else ["density_scatter"])
    if bad:
        raise AssertionError(f"{deck}: not bit for bit the plain version: "
                             f"{bad}")
    return out


def check_density_hdiag_edges(dev, gpu: str) -> None:
    """K16 and K18 at their edges, each bit for bit its plain version: ns
    1, 2 and 4; a fine set larger than the coarse sphere (table slots of
    -1) on a box off every block; K18 with no projectors (q None), a fully
    masked k row, and v0 as a host float."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import density_scatter as k16
    from sirius_tpu_torch.kernels import h_diag as k18

    rng = np.random.default_rng(59)
    dims = (5, 6, 7)
    nbox, ngc, ng = 210, 101, 157
    idx = rng.choice(nbox, ngc, replace=False)
    c2f = rng.choice(ng, ngc, replace=False)
    table = torch.as_tensor(k16.fine_to_coarse_box(idx, c2f, ng), device=dev)
    cases = {}
    for ns in (1, 2, 4):
        acc = torch.as_tensor(rng.random((ns,) + dims), device=dev)
        cases[f"k16.ns{ns}"] = bits_equal(
            k16.density_scatter(acc, 3.7, table, ng),
            k16.density_scatter_plain(acc, 3.7, table, ng))
    nk, ngk = 3, 37
    ekin = torch.as_tensor(rng.random((nk, ngk)), device=dev)
    maskn = (rng.random((nk, ngk)) > 0.3).astype(np.float64)
    maskn[1] = 0.0
    mask = torch.as_tensor(maskn, device=dev)
    for ns in (1, 2, 4):
        q = torch.as_tensor(rng.standard_normal((nk, ns, ngk))
                            + 1j * rng.standard_normal((nk, ns, ngk)),
                            device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        for name, qq, v0 in (("q", q, torch.as_tensor(0.25, **f64)),
                             ("nbeta0", None, torch.as_tensor(-0.5, **f64)),
                             ("v0_float", q, 0.125)):
            cases[f"k18.ns{ns}.{name}"] = bits_equal(
                k18.h_diag_pass(ekin, mask, qq, v0, ns),
                k18.h_diag_pass_plain(ekin, mask, qq, v0, ns))
    emit({"phase": "density_hdiag_edges", "gpu": gpu, "bitwise": cases})
    bad = [k for k, v in cases.items() if not v]
    if bad:
        raise AssertionError(f"K16 / K18 edges not bit for bit: {bad}")


def k17_outputs(res) -> list:
    """A K17 pass's result as a list of tensors (None dropped)."""
    from sirius_tpu_torch.kernels.xc_inputs import XcInputs

    if isinstance(res, XcInputs):
        res = [res.rho_r, res.rho_exc, res.rho_xc, res.mag_r, res.n_up,
               res.n_dn]
    elif not isinstance(res, (list, tuple)):
        res = [res]
    return [t for t in res if t is not None]


def k17_bitwise(a, b) -> bool:
    """Two K17 results bit for bit, NaN payloads and zero signs included."""
    a, b = k17_outputs(a), k17_outputs(b)
    return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))


def potential_calls(ctx, dev, rng, polarized: bool) -> dict:
    """Each K17 pass of one potential at a context's shapes, on seeded
    random fields: {pass: (kernel call, plain call, bytes, operations,
    library call or None)}. A single PyTorch call computes the unpolarized
    stack (Re f as a [1, n1, n2, n3] float64: box.real.unsqueeze(0)
    .contiguous()), no other pass.
    Unpolarized: X + PZ's inputs (K17b without a divergence, one coarse
    field), no K17c (ii); polarized: PBE's (v_up, v_dn, the two divergence
    boxes, K17c (ii)'s rows, V and B_z coarse). No core charge, as in the
    decks."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import coarse_potential as k17d
    from sirius_tpu_torch.kernels import hartree_veff as k17c
    from sirius_tpu_torch.kernels import xc_inputs as k17a
    from sirius_tpu_torch.kernels import xc_outputs as k17b

    dims = tuple(ctx.gvec.fft.dims)
    dims_c = tuple(ctx.fft_coarse.dims)
    n, nbox = int(np.prod(dims)), int(np.prod(dims_c))
    ng, ngc = ctx.gvec.num_gvec, ctx.gvec_coarse.num_gvec
    ns = 2 if polarized else 1

    def real(shape, lo=-1.0, hi=1.0):
        size = int(np.prod(shape))
        return torch.as_tensor(rng.uniform(lo, hi, size),
                               device=dev).view(shape)

    def cplx(shape):
        return torch.complex(real(shape), real(shape))

    rho_box = torch.complex(real(dims, -0.05, 1.0), real(dims, -1e-3, 1e-3))
    mag_box = (torch.complex(real(dims, -1.2, 1.2) * rho_box.real.abs(),
                             real(dims, -1e-3, 1e-3)) if polarized else None)
    floor = 1e-20 if polarized else 0.0
    e = real((n,))
    v_up = real((n,))
    v_dn = real((n,)) if polarized else None
    rho_xc = real(dims, 0.0, 1.0)
    div = torch.complex(real((ns,) + dims), real((ns,) + dims)) if polarized \
        else None
    rho_g, mag_g, vxc_g = cplx((ng,)), cplx((ng,)), cplx((ng,))
    glen2 = torch.as_tensor(np.asarray(ctx.gvec.glen2), device=dev)
    vloc_g = torch.as_tensor(ctx.vloc_g, dtype=torch.complex128, device=dev)
    table = torch.as_tensor(k17d.coarse_box_to_fine(
        ctx.gvec_coarse.fft_index, ctx.coarse_to_fine, nbox, ng), device=dev)
    fields = [cplx((ng,)) for _ in range(ns)]
    boxes = [cplx(dims_c) for _ in range(ns)]
    calls = {
        "xc_inputs": (
            lambda: k17a.xc_inputs(rho_box, None, mag_box, floor),
            lambda: k17a.xc_inputs_plain(rho_box, None, mag_box, floor),
            16 * ns * n + 8 * 3 * ns * n, (2 + 6 * (ns - 1)) * n, None),
        "xc_outputs": (
            lambda: k17b.xc_outputs(e, v_up, rho_xc, v_dn, div),
            lambda: k17b.xc_outputs_plain(e, v_up, rho_xc, v_dn, div),
            (8 * (2 + ns) + (16 * ns if div is not None else 0)) * n
            + (8 + 16 * ns + (8 if polarized else 0)) * n,
            (2 + 5 * (ns - 1)) * n, None),
        "hartree_veff": (
            lambda: k17c.hartree_veff(rho_g, glen2, vloc_g, vxc_g),
            lambda: k17c.hartree_veff_plain(rho_g, glen2, vloc_g, vxc_g),
            (16 + 8 + 16 + 16 + 32) * ng, 12 * ng, None),
        "coarse_fill": (
            lambda: k17d.coarse_fill(fields, table),
            lambda: k17d.coarse_fill_plain(fields, table),
            4 * nbox + 16 * ns * ngc + 16 * ns * nbox, 0.0, None),
        "coarse_stack": (
            lambda: k17d.coarse_stack(boxes, polarized),
            lambda: k17d.coarse_stack_plain(boxes, polarized),
            16 * ns * nbox + 8 * ns * nbox, nbox * (ns - 1) * 2,
            None if polarized
            else lambda: boxes[0].real.unsqueeze(0).contiguous()),
    }
    if polarized:
        calls["gga_inputs"] = (
            lambda: k17c.gga_inputs(rho_g, None, mag_g),
            lambda: k17c.gga_inputs_plain(rho_g, None, mag_g),
            (16 * 2 + 16 * 2) * ng, 8 * 2 * ng, None)
    return calls


def check_potential_kernels(deck: str, ctx, dev, gpu: str, polarized: bool,
                            suffix: str = "") -> dict:
    """K17a-K17d against their plain versions at a deck's shapes
    (potential_calls: unpolarized X + PZ's inputs, or polarized PBE's),
    each a record named potential_passes.<pass><suffix> whose outputs must
    be bit for bit the plain version's; raises otherwise. No core charge,
    as in the decks; library_ms of the one pass a single PyTorch call
    computes (potential_calls), null for the others."""
    import numpy as np

    rng = np.random.default_rng(61 + 2 * polarized)
    out = {}
    for base, (fn_k, fn_p, nbytes, flops, fn_lib) in potential_calls(
            ctx, dev, rng, polarized).items():
        name = "potential_passes." + base + suffix
        got, want = k17_outputs(fn_k()), k17_outputs(fn_p())
        bitwise = k17_bitwise(got, want)
        record_kernel(out, deck, gpu, name, got, want, fn_k, fn_p, fn_lib,
                      float(nbytes), float(flops),
                      extra={"bitwise": bitwise, "polarized": polarized})
    bad = [k for k, r in out.items() if not r["bitwise"]]
    if bad:
        raise AssertionError(f"{deck}: not bit for bit the plain version: "
                             f"{bad}")
    return out


# the K17 edge boxes: 7 x 11 x 13 = 1001 points and 997 G (no multiple of
# the 256-thread block), coarse 5 x 7 x 9 = 315 slots of which 211 hold G
K17_EDGE_DIMS = ((7, 11, 13), (5, 7, 9))
K17_EDGE_NG = (997, 211)
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0)


def check_potential_edges(dev, gpu: str) -> None:
    """K17a-K17d at their edges, each bit for bit its plain version on the
    card: NaN, +-inf and -0.0 in every input (real and imaginary parts);
    rho below each clamp (0, 1e-20, and 1e-25 for exc); |m| above rho_xc;
    glen2 at 0, just under, at and just over 1e-12; odd box and G counts;
    the coarse fill on 1, 2, 3 and 4 fields and the stack on 1, 2 (spin
    and not) and 3; the float64 inputs as views 8 bytes off a 16-byte
    boundary; with and without a core charge. Emits one
    potential_edges line."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import coarse_potential as k17d
    from sirius_tpu_torch.kernels import hartree_veff as k17c
    from sirius_tpu_torch.kernels import xc_inputs as k17a
    from sirius_tpu_torch.kernels import xc_outputs as k17b

    rng = np.random.default_rng(71)
    (dims, dims_c), (ng, ngc) = K17_EDGE_DIMS, K17_EDGE_NG
    n, nbox = int(np.prod(dims)), int(np.prod(dims_c))
    nsp = len(SPECIALS)

    def real(shape, lo=-1.0, hi=1.0, off=0, specials=True):
        size = int(np.prod(shape))
        x = rng.uniform(lo, hi, size + off)
        if specials:
            pos = rng.choice(size, 3 * nsp, replace=False) + off
            x[pos] = np.tile(SPECIALS, 3)
        return torch.as_tensor(x, device=dev)[off:].view(shape)

    def cplx(shape, **kw):
        return torch.complex(real(shape, **kw), real(shape, **kw))

    cases = {}
    for pol in (False, True):
        floor = 1e-20 if pol else 0.0
        for core in (False, True):
            for off in (0, 1):
                rho = real(dims, -0.1, 1.0)
                flat = rho.view(-1)
                flat[:4] = torch.as_tensor([-0.3, 1e-22, 1e-30, -1e-30])
                rho_box = torch.complex(rho, real(dims))
                mag = real(dims, -1.0, 1.0) * rho.abs()
                mag.view(-1)[4:8] = torch.as_tensor([5.0, -5.0, 1e300,
                                                     -1e300])
                mag_box = torch.complex(mag, real(dims)) if pol else None
                core_r = real(dims, 0.0, 0.1, off=off) if core else None
                key = (f"xc_inputs.{'pol' if pol else 'unpol'}."
                       f"{'core' if core else 'nocore'}.off{off}")
                cases[key] = k17_bitwise(
                    k17a.xc_inputs(rho_box, core_r, mag_box, floor),
                    k17a.xc_inputs_plain(rho_box, core_r, mag_box, floor))
        for gga in (False, True):
            ns = 2 if pol else 1
            for off in (0, 1):
                e = real((n,), off=off)
                v_up = real((n,), off=off)
                v_dn = real((n,), off=off) if pol else None
                rho_xc = real(dims, 0.0, 1.0, off=off)
                rho_xc.view(-1)[:3] = torch.as_tensor([1e-30, 1e-25, 0.0])
                div = cplx((ns,) + dims) if gga else None
                key = (f"xc_outputs.{'pol' if pol else 'unpol'}."
                       f"{'gga' if gga else 'lda'}.off{off}")
                cases[key] = k17_bitwise(
                    k17b.xc_outputs(e, v_up, rho_xc, v_dn, div),
                    k17b.xc_outputs_plain(e, v_up, rho_xc, v_dn, div))
    glen2 = real((ng,), 0.0, 5.0, specials=False)
    glen2[:5] = torch.as_tensor([0.0, 1e-12, 0.9e-12, 1.1e-12, 1e-13])
    rho_g, vloc_g, vxc_g, core_g, mag_g = (cplx((ng,)) for _ in range(5))
    cases["hartree_veff"] = k17_bitwise(
        k17c.hartree_veff(rho_g, glen2, vloc_g, vxc_g),
        k17c.hartree_veff_plain(rho_g, glen2, vloc_g, vxc_g))
    for key, core, mag in (("gga_inputs.core", core_g, None),
                           ("gga_inputs.pol", None, mag_g),
                           ("gga_inputs.pol.core", core_g, mag_g)):
        cases[key] = k17_bitwise(k17c.gga_inputs(rho_g, core, mag),
                          k17c.gga_inputs_plain(rho_g, core, mag))
    slots = rng.choice(nbox, ngc, replace=False)
    table = torch.as_tensor(k17d.coarse_box_to_fine(
        slots, rng.choice(ng, ngc, replace=False), nbox, ng), device=dev)
    for nf in (1, 2, 3, 4):
        fields = [cplx((ng,)) for _ in range(nf)]
        cases[f"coarse_fill.{nf}"] = k17_bitwise(
            k17d.coarse_fill(fields, table),
            k17d.coarse_fill_plain(fields, table))
    for nf, spin in ((1, False), (2, False), (2, True), (3, False)):
        boxes = [cplx(dims_c) for _ in range(nf)]
        cases[f"coarse_stack.{nf}{'.spin' if spin else ''}"] = k17_bitwise(
            k17d.coarse_stack(boxes, spin), k17d.coarse_stack_plain(boxes,
                                                                    spin))
    emit({"phase": "potential_edges", "gpu": gpu, "bitwise": cases})
    bad = [k for k, v in cases.items() if not v]
    if bad:
        raise AssertionError(f"K17 edges not bit for bit: {bad}")


@contextlib.contextmanager
def timed_checkpoint_io():
    """Time every save_state of run_scf and every FusedScf.fetch_state
    (with or without the mixer history) while the block runs."""
    from sirius_tpu_torch.dft import scf as scf_mod
    from sirius_tpu_torch.dft.fused import FusedScf

    save, fetch = scf_mod.save_state, FusedScf.fetch_state
    times = {"save": [], "fetch": [], "fetch_history": []}

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        times["save"].append(time.perf_counter() - t0)

    def timed_fetch(self, with_history=False):
        t0 = time.perf_counter()
        out = fetch(self, with_history)
        times["fetch_history" if with_history else "fetch"].append(
            time.perf_counter() - t0)
        return out

    scf_mod.save_state, FusedScf.fetch_state = timed_save, timed_fetch
    try:
        yield times
    finally:
        scf_mod.save_state, FusedScf.fetch_state = save, fetch


def checkpoint_resume(ctx, dev, gpu: str, want: dict,
                      phase: str = "checkpoint_resume_us", spec=FULL,
                      deck_name: str = "si16_supercell2_us_sym") -> dict:
    """full_width_us's cell with control.autosave_every = 5, killed by the
    scf.autosave_kill fault right after the iteration-5 autosave, resumed
    by run_scf(resume=find_resumable(...)): it must end at full_width_us's
    fixed count with the total energy within 1e-10 Ha of that run (want);
    bit for bit or not is printed. The file's bytes, the save, load
    (digest included) and fetch_state seconds. Then the same file resumed
    through run_scf_from_file's ground_state_restart from a JSON deck of
    the cell in a temporary directory: the same gate, and sirius.h5
    written and loadable. ctx is the ultrasoft + symmetry context of spec
    (make_context(spec, ..., US_SYM)) at full_width_us's iteration count,
    run to the end."""
    import tempfile

    from sirius_tpu_torch.dft.scf import run_scf, run_scf_from_file
    from sirius_tpu_torch.io.checkpoint import find_resumable, load_state
    from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                          synthetic_silicon_species,
                                          write_deck)
    from sirius_tpu_torch.utils import faults

    every, n_full = 5, FULL_ITERS["full_width_us"]
    c = ctx.cfg.control
    with tempfile.TemporaryDirectory() as tmp:
        auto = os.path.join(tmp, "auto.h5")
        c.autosave_every, c.autosave_path = every, auto
        faults.install([("scf.autosave_kill", every - 1, "raise")])
        killed = False
        t0 = time.perf_counter()
        try:
            with timed_checkpoint_io() as io_times:
                run_scf(ctx.cfg, ctx=ctx, device=dev)
        except faults.SimulatedKill:
            killed = True
        finally:
            faults.clear()
            c.autosave_every, c.autosave_path = 0, ""
        killed_s = time.perf_counter() - t0
        path = find_resumable(auto)
        nbytes = os.path.getsize(path) if path else 0
        t0 = time.perf_counter()
        load_state(path, ctx)
        load_s = time.perf_counter() - t0
        reset_launches()
        res = run_scf(ctx.cfg, ctx=ctx, device=dev, resume=path)
        launches = read_launches()
        d_total = res["energy"]["total"] - want["energy"]["total"]
        bitwise = (res["energy"] == want["energy"]
                   and res["etot_history"] == want["etot_history"])
        # the CLI route: the cell as a deck, the autosave at its default
        # path beside it, task ground_state_restart
        deck = synthetic_silicon_deck(
            **spec, use_symmetry=True,
            extra_params={"num_dft_iter": n_full, **RUN_TO_END})
        deck_path = write_deck(os.path.join(tmp, "deck"), deck,
                               synthetic_silicon_species(ultrasoft=True),
                               "upf")
        deck_dir = os.path.dirname(deck_path)
        with open(path, "rb") as src, open(
                os.path.join(deck_dir, "sirius_autosave.h5"), "wb") as dst:
            dst.write(src.read())
        t0 = time.perf_counter()
        with working_directory(tmp):
            rc = run_scf_from_file(deck_path, task="ground_state_restart",
                                   device=dev)
        cli_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "output.json")) as f:
            gs = json.load(f)["ground_state"]
        state_file = os.path.join(deck_dir, "sirius.h5")
        h5_bytes = (os.path.getsize(state_file)
                    if os.path.exists(state_file) else 0)
        h5_ok = bool(h5_bytes) and "psi" in load_state(state_file, ctx)
    d_cli = gs["energy"]["total"] - want["energy"]["total"]
    rec = {"phase": phase, "gpu": gpu, "deck": deck_name,
           "autosave_every": every, "killed": killed,
           "killed_run_seconds": killed_s, "resumed_from": path is not None,
           "file_bytes": nbytes, "save_seconds": io_times["save"],
           "fetch_state_seconds": io_times["fetch"],
           "fetch_state_history_seconds": io_times["fetch_history"],
           "load_seconds": load_s,
           "num_scf_iterations": res["num_scf_iterations"],
           "d_total": d_total, "bitwise": bitwise,
           "iteration_seconds": res["iteration_seconds"],
           "device_scf": res["device_scf"], "launches": launches,
           "cli_rc": rc, "cli_iterations": gs["num_scf_iterations"],
           "cli_d_total": d_cli, "cli_seconds": cli_s,
           "sirius_h5_bytes": h5_bytes, "sirius_h5_loads": h5_ok}
    emit(rec)
    if not killed or path is None:
        raise AssertionError(f"{phase}: the run was not killed after its "
                             "autosave, or left no resumable file")
    for label, n, d in (("resume", res["num_scf_iterations"], d_total),
                        ("ground_state_restart", gs["num_scf_iterations"],
                         d_cli)):
        if n != n_full or not abs(d) <= 1e-10:
            raise AssertionError(f"{phase}: {label} ended at {n} iterations"
                                 f" (want {n_full}), |dE| {abs(d)} Ha")
    if rc != 0 or not h5_ok:
        raise AssertionError(f"{phase}: ground_state_restart exit {rc}, "
                             f"sirius.h5 written and loadable: {h5_ok}")
    check_launched(phase, dev, launches, US_FUSED, "kset",
                   n_full - every)
    return rec


def recovery_fused(ctx, dev, gpu: str, phase: str = "recovery_fused") -> dict:
    """The supervisor on the card, on the 2-atom US k-set deck (the fused
    step): the unperturbed run (snapshots taken, host syncs an iteration
    with the supervisor on); a NaN density at iteration 3 (one recovery,
    device_nonfinite, the energy within 1e-8 Ha of the unperturbed run);
    NaN densities at iterations 4, 7 and 10 with num_dft_iter 120 (the
    actions flush_history, halve_beta_linear, disable_device_scf, and
    convergence); a device.oom fault at iteration 2 (the OOM ladder's first
    rung that applies on a multi-k deck, disable_device_scf, and
    convergence); and on the host loop (device_scf off) a NaN density at
    iteration 3 (one rollback from the device snapshot, nonfinite_fields,
    1e-8 Ha of the unperturbed run)."""
    from sirius_tpu_torch.dft import scf as scf_mod
    from sirius_tpu_torch.dft.fused import FusedScf
    from sirius_tpu_torch.utils import faults

    fetch = FusedScf.fetch_state
    snaps = {"n": 0}

    def counted(self, with_history=False):
        snaps["n"] += 1
        return fetch(self, with_history)

    FusedScf.fetch_state = counted
    try:
        reset_launches()

        def base_run():
            return scf_mod.run_scf(ctx.cfg, ctx=ctx, device=dev)

        # host syncs are counted on the card (the CPU has none to count)
        base, syncs = (count_syncs(base_run) if dev.type == "cuda"
                       else (base_run(), None))
        launches = read_launches()
    finally:
        FusedScf.fetch_state = fetch
    e0 = base["energy"]["total"]
    runs = {}
    plans = {"nan3": ([("scf.density", 3, "nan")], None, "auto"),
             "nan4_7_10": ([("scf.density", i, "nan") for i in (4, 7, 10)],
                           120, "auto"),
             "oom2": ([("device.oom", 2, "raise")], None, "auto"),
             # the host loop's rollback from its device snapshot
             "host_nan3": ([("scf.density", 3, "nan")], None, "off")}
    p, c = ctx.cfg.parameters, ctx.cfg.control
    n0 = p.num_dft_iter
    for name, (plan, iters, mode) in plans.items():
        faults.install(plan)
        if iters:
            p.num_dft_iter = iters
        c.device_scf = mode
        try:
            r = scf_mod.run_scf(ctx.cfg, ctx=ctx, device=dev)
        finally:
            faults.clear()
            p.num_dft_iter, c.device_scf = n0, "auto"
        runs[name] = {
            "ladder": [(h["sentinel"], h["action"], h["rung"],
                        h["rolled_back_to"]) for h in
                       r["recovery"]["ladder_history"]],
            "converged": r["converged"],
            "num_scf_iterations": r["num_scf_iterations"],
            "device_scf_at_end": r["device_scf"],
            "d_total": r["energy"]["total"] - e0}
    rec = {"phase": phase, "gpu": gpu, "deck": "full_width_2atom_us_sym",
           "base_iterations": base["num_scf_iterations"],
           "base_converged": base["converged"], "e_total": e0,
           "snapshots": snaps["n"],
           "syncs_per_iteration": (None if syncs is None
                                   else syncs / base["num_scf_iterations"]),
           "runs": runs}
    emit(rec)
    check_launched(phase, dev, launches, US_FUSED, "kset",
                   base["num_scf_iterations"])
    one = runs["nan3"]
    if ([x[:2] for x in one["ladder"]] != [("device_nonfinite",
                                            "flush_history")]
            or not abs(one["d_total"]) <= 1e-8 or not one["converged"]):
        raise AssertionError(f"{phase}: nan3 {one}")
    three = runs["nan4_7_10"]
    if ([x[1] for x in three["ladder"]] != ["flush_history",
                                            "halve_beta_linear",
                                            "disable_device_scf"]
            or not three["converged"] or three["device_scf_at_end"]):
        raise AssertionError(f"{phase}: nan4_7_10 {three}")
    oom = runs["oom2"]
    if ([x[:2] for x in oom["ladder"]] != [("device_oom",
                                            "disable_device_scf")]
            or not oom["converged"]):
        raise AssertionError(f"{phase}: oom2 {oom}")
    host = runs["host_nan3"]
    if ([x[:2] for x in host["ladder"]] != [("nonfinite_fields",
                                             "flush_history")]
            or not abs(host["d_total"]) <= 1e-8 or not host["converged"]):
        raise AssertionError(f"{phase}: host_nan3 {host}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import sirius_tpu_torch
    from sirius_tpu_torch.kernels import build

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        sirius_tpu_torch.__file__)))
    if pkg_root != here:
        print(f"chip_smoke: sirius_tpu_torch found at {pkg_root}, not beside "
              "this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_main = time.perf_counter()
    smi = nvidia_smi()
    gpu = f"{torch.cuda.get_device_name(0)} ({smi})"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    compiled = build.build_all()
    emit({"phase": "build", "gpu": gpu, "nvcc": build.nvcc_path(),
          "seconds": time.perf_counter() - t0, "compiled": compiled})
    check_kernel_edges(dev, gpu)
    check_density_hdiag_edges(dev, gpu)
    check_potential_edges(dev, gpu)
    check_eigh_empty_rows(dev, gpu)

    with open(os.path.join(here, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    t0 = time.perf_counter()
    ctx2 = make_context(PARITY, TIGHT)
    ctx16 = make_context(FULL, {"num_dft_iter": FULL_ITERS["full_width"],
                                **RUN_TO_END})
    ctx2us = make_context(PARITY, TIGHT, US_SYM)
    ctx16us = make_context(FULL, {"num_dft_iter": FULL_ITERS["full_width_us"],
                                  **RUN_TO_END}, US_SYM)
    single = {name: single_k_context(name) for name in SINGLE_K}
    xc_decks = {name: xc_context(name) for name in XC_DECKS}
    # one 54-atom context for both single-k runs (~15 s on the host)
    ctx54 = make_context(GAMMA54, {"num_dft_iter": FULL_ITERS[
        "full_width_gamma_us"], **RUN_TO_END}, US_SYM)
    ctx54fm = magnetic_supercell_context(
        3, GAMMA54, {"num_dft_iter": FULL_ITERS["full_width_gamma_pbe_fm"],
                     **RUN_TO_END, "xc_functionals": PBE, **SPIN}, US_SYM, 0.5)
    ctx16scan = make_context(FULL, {
        "num_dft_iter": FULL_ITERS["full_width_scan_us"], **RUN_TO_END,
        "xc_functionals": SCAN}, US_SYM)
    tool = reference_tool()
    spinor = {name: deck_context(name, tool) for name in tool.SPINOR_DECKS}
    ctx16nc = magnetic_supercell_context(
        2, FULL, {"num_dft_iter": FULL_ITERS["full_width_spinor_us"],
                  **RUN_TO_END, **NONCOLLINEAR}, US_SYM, CANTED[0])
    emit({"phase": "contexts", "seconds": time.perf_counter() - t0})

    check_kernels("full_width_2atom", ctx2, dev, gpu)
    kern16 = check_kernels("si16_supercell2", ctx16, dev, gpu)
    check_kernels_us("full_width_2atom_us_sym", ctx2us, dev, gpu)
    kern16.update(check_kernels_us("si16_supercell2_us_sym", ctx16us, dev, gpu))
    check_kernels_gamma("gamma_us_sym", single["gamma_us_sym"], dev, gpu)
    kern54 = check_kernels_gamma("si54_supercell3_gamma", ctx54, dev, gpu)
    kern54fm = {}
    kern54.update(check_kernels_aug54("si54_supercell3_gamma", ctx54, dev, gpu,
                                      kern54fm))
    kern54.update(check_kernel_symmetrize("si54_supercell3_gamma", ctx54, dev,
                                          gpu))
    # K4 on the stress's strained Q(G) tables at the 16-atom US shape
    kern_strained = check_rho_aug_strained("si16_supercell2_us_sym", ctx16us,
                                           dev, gpu)
    check_kernel_chunk("chunked_us_sym", single["chunked_us_sym"], 1, dev, gpu)
    kern54.update(check_kernel_chunk("si54_supercell3_chunk16", ctx54, CHUNK54,
                                     dev, gpu))
    kern_mgga = check_kernels_xc("si16_supercell2", ctx16, dev, gpu)
    kern54xc = check_kernels_xc("si54_supercell3_gamma", ctx54, dev, gpu)
    kern_mgga.update(check_kernels_tau("si16_supercell2_us_sym", ctx16us, dev,
                                       gpu))
    check_kernel_axial("pw_us_sym_afm", xc_decks["pw_us_sym_afm"], dev, gpu)
    kern54xc.update(check_kernel_axial("si54_supercell3_gamma_fm", ctx54fm,
                                       dev, gpu))
    check_kernels_spinor("spinor_pbe_us_sym", spinor["spinor_pbe_us_sym"], dev,
                         gpu)
    kern_spinor = check_kernels_spinor("si16_supercell2_us_sym_spinor", ctx16nc,
                                       dev, gpu)
    # the fp32 instantiations at the full-width shapes of their fp64 rows
    kern_fp32 = check_kernels("si16_supercell2_us_sym", ctx16us, dev, gpu,
                              fp32=True)
    kern_fp32.update(check_kernels_us("si16_supercell2_us_sym", ctx16us, dev,
                                      gpu, fp32=True))
    kern_fp32.update(check_kernels_gamma("si54_supercell3_gamma", ctx54, dev,
                                         gpu, fp32=True))
    kern_fp32.update(check_kernel_chunk("si54_supercell3_chunk16", ctx54,
                                        CHUNK54, dev, gpu, fp32=True))
    kern_fp32.update(check_kernels_tau("si16_supercell2_us_sym", ctx16us, dev,
                                       gpu, fp32=True))
    kern_fp32.update(check_kernels_spinor("si16_supercell2_us_sym_spinor",
                                          ctx16nc, dev, gpu, fp32=True))
    # the fused step's K13, K14a, K14b and K15 at the 16-atom US shapes
    kern_fused = check_fused_kernels("si16_supercell2_us_sym", ctx16us, dev,
                                     gpu)
    # K16a, K16b and K18 at the same shapes, bit for bit
    kern_fused.update(check_density_hdiag_kernels("si16_supercell2_us_sym",
                                                  ctx16us, dev, gpu))
    # K17a-K17d at the 16-atom US shapes (unpolarized X + PZ inputs, then
    # polarized PBE ones) and at the 54-atom PBE FM cell, bit for bit
    kern_potential = check_potential_kernels("si16_supercell2_us_sym",
                                             ctx16us, dev, gpu, False,
                                             ".unpolarized")
    check_potential_kernels("si16_supercell2_us_sym", ctx16us, dev, gpu,
                            True)
    kern_potential54 = check_potential_kernels(
        "si54_supercell3_gamma_fm", ctx54fm, dev, gpu, True, ".54")
    torch.cuda.empty_cache()
    parity_scf(ctx2, dev, refs["full_width_2atom"], gpu, required=NC_FUSED)
    full_width(ctx16, dev, gpu, required=NC_FUSED)
    parity_scf(ctx2us, dev, refs["full_width_2atom_us_sym"], gpu,
               phase="parity_scf_us", deck="full_width_2atom_us_sym",
               required=US_FUSED)
    entry_point_cli(dev, gpu, refs["full_width_2atom_us_sym"])
    # the supervisor's rollbacks on the fused step
    recovery_fused(ctx2us, dev, gpu)
    # the fused step's records against the JAX package's, sync-free
    parity_fused_record(dev, gpu, refs, tool)
    for name in MIXER_DECKS:
        parity_scf(deck_context(name, tool), dev, refs[name], gpu,
                   phase="parity_scf_" + name.removesuffix("_us_sym"),
                   deck=name, required=US_KERNELS)
    launches, res64 = full_width(ctx16us, dev, gpu, phase="full_width_us",
                                 required=US_FUSED, with_result=True)
    rms64 = res64["rms_history"]
    # the same cell from a deck file with UPF species, bit for bit
    full_width_us_from_file(dev, gpu, res64)
    # killed after its iteration-5 autosave, resumed, and restarted from
    # the file by the CLI's ground_state_restart
    checkpoint_resume(ctx16us, dev, gpu, res64)
    # the fused step against the host loop on the same cell, in turns
    fused_ab(ctx16us, dev, gpu)
    # the same run on the fp32 path, polished to fp64 after iteration 3 or 4
    ctx16us.cfg.parameters.precision_wf = "fp32"
    ctx16us.cfg.settings.fp32_to_fp64_rms = polish_threshold(rms64)
    # (its two fp64 iterations still mix the fp32 iterations' densities,
    # so its electron count is held as an fp32 run's)
    runs_fp32 = {"full_width_us_fp32": full_width(
        ctx16us, dev, gpu, phase="full_width_us_fp32",
        required=FP32_US_FUSED, deck="si16_supercell2_us_sym",
        electron_tol=fp32_electron_tol(
            refs, ctx16us.unit_cell.num_valence_electrons))}
    for name, ctx in single.items():
        path, required = SINGLE_K_PATH[name]
        parity_scf(ctx, dev, refs[name], gpu,
                   phase="parity_scf_" + name.replace("_sym", ""), deck=name,
                   required=required, path=path)
    torch.cuda.empty_cache()
    launches54 = full_width(ctx54, dev, gpu, phase="full_width_gamma_us",
                            required=GAMMA_US_KERNELS,
                            deck="si54_supercell3_gamma", path="gamma")
    torch.cuda.empty_cache()
    ctx54.cfg.parameters.precision_wf = "fp32"
    runs_fp32["full_width_gamma_us_fp32"] = full_width(
        ctx54, dev, gpu, phase="full_width_gamma_us_fp32",
        required=FP32_GAMMA_US_KERNELS, deck="si54_supercell3_gamma",
        path="gamma", electron_tol=fp32_electron_tol(
            refs, ctx54.unit_cell.num_valence_electrons))
    ctx54.cfg.parameters.precision_wf = "fp64"
    ctx54.cfg.control.beta_chunked = True
    ctx54.cfg.control.beta_chunk_size = CHUNK54
    torch.cuda.empty_cache()
    launches54.update(beta_chunk=full_width(
        ctx54, dev, gpu, phase="full_width_chunked_us",
        required=CHUNKED_US_KERNELS, deck="si54_supercell3_gamma",
        path="chunked")["beta_chunk"])
    del ctx54
    runs = {"full_width_gamma_us": launches54}
    for name, ctx in xc_decks.items():
        path, required = XC_DECK_PATH[name]
        runs[name] = parity_scf(
            ctx, dev, refs[name], gpu,
            phase="parity_scf_" + name.replace("_sym", ""), deck=name,
            required=required, path=path)
    # the stress's other XC forms, card against CPU on one state
    check_stress_forms(dev, gpu)
    # the recorded force decks: energies, moments, forces and stress
    for name in tool.FORCES_DECKS:
        path, required, _ = FORCES_DECK_PATH[name]
        runs[name] = parity_scf(
            deck_context(name, tool), dev, refs[name], gpu,
            phase="parity_forces_" + name.removeprefix("forces_"), deck=name,
            required=required, path=path)
    torch.cuda.empty_cache()
    runs["full_width_gamma_pbe_fm"] = full_width(
        ctx54fm, dev, gpu, phase="full_width_gamma_pbe_fm",
        required=FULL_GAMMA_PBE_FM_KERNELS, deck="si54_supercell3_gamma_fm",
        path="gamma")
    del ctx54fm
    torch.cuda.empty_cache()
    runs["full_width_scan_us"] = full_width(
        ctx16scan, dev, gpu, phase="full_width_scan_us",
        required=FULL_SCAN_KERNELS, deck="si16_supercell2_us_sym_scan")
    del ctx16scan
    torch.cuda.empty_cache()
    # K4's launches on strained tables: those of one full-width stress
    stress16 = full_width_forces(dev, gpu)
    launches_strained = {name: stress16.get(name, 0) for name in kern_strained}
    for name, ctx in spinor.items():
        runs[name] = parity_scf(
            ctx, dev, refs[name], gpu, phase="parity_scf_" + name, deck=name,
            required=SPINOR_DECK_PATH[name], path="kset_nc")
    del spinor
    torch.cuda.empty_cache()
    runs["full_width_spinor_us"] = full_width(
        ctx16nc, dev, gpu, phase="full_width_spinor_us",
        required=SPINOR_SYM_KERNELS, deck="si16_supercell2_us_sym_spinor",
        path="kset_nc")
    torch.cuda.empty_cache()
    # spin-orbit: the 2-atom decks from their files, then the 16-atom cell
    for name in tool.FILE_DECKS:
        runs[name] = parity_scf(
            deck_context(name, tool), dev, refs[name], gpu,
            phase="parity_scf_" + name, deck=name,
            required=SO_DECK_PATH[name], path="kset_nc")
    ctx_so = spin_orbit_supercell_context()
    runs["full_width_spinor_so_us"] = full_width(
        ctx_so, dev, gpu,
        phase="full_width_spinor_so_us", required=SPINOR_SYM_KERNELS,
        deck="si16_supercell2_us_sym_spinor_so", path="kset_nc")
    spin_orbit_host_step(ctx_so, dev, gpu)
    del ctx_so
    torch.cuda.empty_cache()
    ctx16nc.cfg.parameters.precision_wf = "fp32"
    runs_fp32["full_width_spinor_us_fp32"] = full_width(
        ctx16nc, dev, gpu, phase="full_width_spinor_us_fp32",
        required=FP32_SPINOR_SYM_KERNELS,
        deck="si16_supercell2_us_sym_spinor", path="kset_nc",
        electron_tol=fp32_electron_tol(
            refs, ctx16nc.unit_cell.num_valence_electrons))
    del ctx16nc
    torch.cuda.empty_cache()
    for name in FP32_DECK_PATH:
        runs_fp32[name] = parity_scf_fp32(deck_context(name, tool), dev, refs,
                                          name, gpu)
    launches_spinor = {name: runs["full_width_spinor_us"][name]
                       for name in kern_spinor}
    launches_mgga = {name: runs[deck][name] for name, deck in
                     {**SUMMARY_MGGA, **SUMMARY_XC96}.items()}
    kern_mgga = {name: kern_mgga[name] for name in launches_mgga}
    launches_xc = {name: runs[deck][name] for name, deck in SUMMARY_XC.items()}
    launches_xc.update({name: runs["full_width_gamma_pbe_fm"][name] for name in
                        ("xc_gradient.gradient_boxes",
                         "xc_gradient.divergence_pw", "symmetrize_pw.axial")})
    kern54xc = {name: kern54xc[name] for name in launches_xc}

    emit({"phase": "total", "seconds": time.perf_counter() - t_main})
    summary = []
    launches_fp32 = {name: runs_fp32[run][name]
                     for name, run in FP32_SUMMARY.items()}
    for records, counts in ((kern16, launches), (kern_fused, launches),
                            (kern_potential, launches),
                            (kern_potential54,
                             runs["full_width_gamma_pbe_fm"]),
                            (kern54, launches54),
                            (kern54fm, runs["full_width_gamma_pbe_fm"]),
                            (kern54xc, launches_xc),
                            (kern_mgga, launches_mgga),
                            (kern_spinor, launches_spinor),
                            (kern_strained, launches_strained),
                            (kern_fp32, launches_fp32)):
        for name, rec in records.items():
            summary.append({
                "name": name, "deck": rec["deck"], "route": "cuda",
                "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
