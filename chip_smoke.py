"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of sirius_tpu. Phases, each printing JSON lines:

1. device and build: the card's name and power limit; the kernel sources
   of sirius_tpu_torch/csrc/ compiled by nvcc, one process each, all at
   once;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the parity decks and of the full-width decks (norm-conserving: K1,
   K2, K3, K7; ultrasoft + symmetry: K1c, K4, K5, K6; Gamma packed-real:
   K8a, K8b, K1c in real mode, K2 on float64 blocks; chunked projectors:
   K9; the XC kernels at the fine boxes of the 16- and 54-atom cells: K7b
   for X + PW92 and X + VWN5, K7g for PBE and PBEsol, K7s for SCAN, each
   polarized and unpolarized, on densities with dead channels and fully
   polarized points, K10a and K10b, and K6 on an axial field; the tau
   operator's K11a and K11b at the 16-atom coarse box; the non-collinear
   kernels at the 2-atom and 16-atom spinor decks: K12a, K12b, K6v and K4
   on four channels; and the fp32 instantiations, at the full-width shapes
   of their fp64 rows and held to 1e-5 relative: K1, K1c, K2 and K3 on
   complex64 at the 16-atom US deck, K8a, K8b, K1c real and K2 on float32
   packed blocks at 54 atoms, K9 at 54 atoms and 16 a chunk, K11a and K11b
   at the 16-atom coarse box, K12a on the spinor k-set block and K12b on
   one k-point's); K5 also at the 54-atom Gamma cell on one and two
   channels (records only) and on the spinor deck's four channels, each
   launched twice on the same inputs for a bitwise-equal D, with the
   device time of its launches from torch.profiler beside the event time
   (device_ms); K1c records whether it is bitwise its plain version;
   K6 also at the 54-atom Gamma cell (1296 ops), where its yardstick
   cannot be built; every K6 and K6v record holds the factorised kernel
   against the unfactorised plain version on a random field too, and
   carries the group's factorisation (num_translations, num_reps,
   num_live) and the unfactorised sum's operations bound; every K2 record
   its cluster size; before them, the edge shapes of the redesigned K1c,
   K5 and K2 (check_kernel_edges: odd row lengths, views off a 16-byte
   boundary, G counts off every tile and chunk, 1, 2 and 4 channels, more
   atoms than one launch, K2's four instantiations at rows just over and
   under its cluster threshold, with and without w): error,
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
   kernel launches per iteration and per band solve, the precision and
   seconds of each iteration, peak device memory, electron count, total
   moment, finite energies.

Every SCF phase sets the launch counts to 0 just before its run and reads
them just after, and fails if a kernel of its path was not launched. The
kernels summary takes each kernel's launches from the full-width run of its
path: full_width_us for K1-K7, full_width_gamma_us for K8a, K8b, K1c real
and K2 float64, full_width_chunked_us for K9, full_width_gamma_pbe_fm for
K7g (PBE), K10a, K10b and K6 on axial fields, full_width_scan_us for K7s
unpolarized, K11a and K11b, full_width_spinor_us for K12a, K12b, K6v and
K4 on four channels; K7b's X + PW92 and X + VWN5 rows, K7g's PBEsol
row and K7s's polarized row take theirs from the parity decks that run
them (parity_scf_pw_us_afm, parity_scf_gamma_nc_vwn,
parity_scf_gamma_nc_pbesol, parity_scf_scan_us_fm); the fp32 rows from
the run FP32_SUMMARY names.

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
# outside the tensor cores, the rates of these kernels' elementwise work
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12
FP32_FLOPS_PER_S = 67e12

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
# the XC kernel checks: functionals, polarized
XC_CHECKS = {
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
# K7s as K7g, held to 1e-12; K11a / K11b are a store and a gather with
# products and sums in the plain version's order (rounding only)
TOL = {**{name: 1e-11 for name in XC_CHECKS},
       "mgga_xc.scan": 1e-12, "mgga_xc.scan.unpolarized": 1e-12,
       "mgga_tau.grad_to_box": 1e-14, "mgga_tau.box_to_pw_tau": 1e-14,
       "xc_gradient.gradient_boxes": 1e-12,
       "xc_gradient.divergence_pw": 1e-12, "symmetrize_pw.axial": 1e-13,"local_hpsi.pw_to_box": 1e-12, "local_hpsi.box_to_pw_hpsi": 1e-12,
       "davidson_residual": 1e-12, "density_accumulate": 1e-11,
       "lda_xc": 1e-11, "veff_multiply": 1e-12,
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
       "augmentation.d_operator.4": 1e-12}
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
# the kernels summary: the new rows of K7b / K7g (a record at the 54-atom
# box, in the mode its deck runs) and the run their launches come from
SUMMARY_XC = {"lda_xc.pw92": "pw_us_sym_afm",
              "lda_xc.vwn.unpolarized": "gamma_nc_vwn",
              "gga_xc.pbe": "full_width_gamma_pbe_fm",
              "gga_xc.pbesol.unpolarized": "gamma_nc_pbesol"}
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


def bound(nbytes: float, flops: float,
          fp32: bool = False) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / (FP32_FLOPS_PER_S if fp32 else FP64_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(a, b) -> tuple[float, float]:
    import torch

    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / scale if scale > 0 else err


def record_kernel(out, deck, gpu, name, kernel_out, plain_out, fn_k, fn_p,
                  fn_lib, nbytes, flops, slow_plain=False, extra=None):
    """Compare one kernel with its plain version, time both (and the
    library yardstick), emit the record (with the fields of extra) and
    keep it in out[name]."""
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)
            if a is not None]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ms = time_ms(fn_k)
    # a plain version that loops in Python is timed over fewer samples
    plain_ms = (time_ms(fn_p, samples=5, inner=1, warm=1) if slow_plain
                else time_ms(fn_p))
    lib_ms = time_ms(fn_lib) if fn_lib is not None else None
    b_ms, b_by = bound(nbytes, flops, name.endswith(FP32_SUFFIXES))
    rec = {"phase": "kernel", "deck": deck, "name": name, "gpu": gpu,
           "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": TOL[name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, **(extra or {})}
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


# K1c's edge shapes: (case, row length, view offset in elements); an odd
# row length puts every other complex64 row 8 bytes off a 16-byte boundary,
# a one-element offset all of them (a complex128 element stays aligned)
K1C_EDGES = (("odd n", 27 ** 3, 0), ("offset view", 30 ** 3, 1),
             ("odd n, offset view", 27 ** 3, 1))


def synthetic_aug_tables(rng, na: int, ng: int, dev) -> dict:
    """One type's K5 tables of random values: na atoms of 4 projectors
    (nqlm 10 packed pairs), Millers in [-15, 15], the pair indices of
    ops/augmentation.py::build_aug_device_tables."""
    import numpy as np
    import torch

    xi1, xi2 = np.triu_indices(4)
    nbeta = 4 * na
    off = 4 * np.arange(na)[:, None]
    gidx = (off + xi1) * nbeta + off + xi2
    lo_idx = (off + xi2) * nbeta + off + xi1

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    q = rng.standard_normal((10, ng)) + 1j * rng.standard_normal((10, ng))
    return {"millers": t(rng.integers(-15, 16, (ng, 3)), torch.int32),
            "pos": t(rng.uniform(0.0, 1.0, (na, 3)), torch.float64),
            "q": t(q, torch.complex128),
            "gidx": t(gidx, torch.int32), "lo_idx": t(lo_idx, torch.int32),
            "lo_mask": t(xi1 != xi2, torch.float64)}


def check_kernel_edges(dev, gpu: str) -> None:
    """K1c and K5 against their plain versions at the shapes their vector
    paths and launch plans treat apart. K1c, both modes and both
    precisions, [2, 11, n] with ns = 2 (11 rows: not a whole row group) at
    the K1C_EDGES cases, bitwise, the elements around the view untouched.
    K5 at ng = 10007 (no multiple of any tile or chunk) on 7 atoms with 1,
    2 and 4 channels, at ng = 29 (below one tile), and on four channels of
    more atoms than one launch takes, each at 1e-12 relative and
    twice on the same inputs with a bitwise-equal D. Emits one
    kernel_edges line a case."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import augmentation as k45
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
    check_residual_edges(dev, gpu, rng)


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
           nbytes=nfine * 24, flops=nfine * 60.0)
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
    from sirius_tpu_torch.kernels import augmentation as k45
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
    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    a = rng.standard_normal((nbeta, nbeta)) + 1j * rng.standard_normal((nbeta, nbeta))
    dm = torch.as_tensor((a + a.conj().T)[None] * 0.05, device=dev)
    targs = (aug["gidx"], aug["w"], aug["millers"], aug["pos"], aug["q"])
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    dmp = (aug["w"][None, None, :] * dm.reshape(1, -1)[:, aug["gidx"].long()].real
           ).to(torch.complex128)
    record("augmentation.rho_aug", [k45.rho_aug(dm, *targs)],
           [k45.rho_aug_plain(dm, *targs)],
           lambda: k45.rho_aug(dm, *targs),
           lambda: k45.rho_aug_plain(dm, *targs),
           lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, aug["q"]),
           nbytes=nqlm * ng * 16 + ng * 16 + ng * 12 + nbeta * nbeta * 16,
           flops=ng * (na * (5.0 + 2.0 + nqlm * 4.0) + nqlm * 8.0))
    del ph, dmp
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
    record("gamma_pack.box_to_packed_hx" + sfx_r,
           list(k8.box_to_packed_hx(vbox, x, *pargs)),
           list(k8.box_to_packed_hx_plain(vbox, x, *pargs)),
           lambda: k8.box_to_packed_hx(vbox, x, *pargs),
           lambda: k8.box_to_packed_hx_plain(vbox, x, *pargs), None,
           nbytes=(rows * (2 * npair + 1) * cb + rows * ngk * 3 * rb
                   + ngk * 2 * rb + npair * 8),
           flops=rows * ngk * 6.0)
    del vbox

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
                  flops=c * nxi * ngk * 14.0 + c * ngk * 7.0 + ngk * 3.0)
    return out


def xc_operations(names, polarized: bool) -> float:
    """fp64 operations a point of K7b / K7g / K7s, by a stated rule: the
    torch operations of each functional's energy in the plain version (each
    elementary function, pow, exp, expm1, log, sqrt, atan, counted as one),
    times 1 + the number of partial derivatives the kernel carries for that
    term, plus the sigma and flux products of GGA and mGGA. K7b / K7g carry
    5 partials polarized GGA, 2 otherwise. K7s, term by term: SCAN exchange
    is one scan_x_half per spin channel on Dual<3> polarized (two halves),
    one unpolarized (0.5 (x + x)); SCAN correlation runs on Dual<4>
    polarized, Dual<3> unpolarized; the LDA and GGA names of a mixed list
    on Dual<5> polarized, Dual<3> unpolarized."""
    import torch
    from torch.overrides import TorchFunctionMode

    from sirius_tpu_torch.kernels.xc_functionals import (GGA_FUNCS,
                                                        MGGA_FUNCS, energy,
                                                        scan_c_e, scan_x_half)

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
    if not mgga:
        partials = 5 if (gga and polarized) else 2
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
    on some points. Returns {kernel: record}."""
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
        ops = xc_operations(names, pol)
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
        # no single PyTorch call evaluates a functional: library_ms null
        record(name, list(kern()), list(plain()), kern, plain, None,
               nbytes=nbytes, flops=n * ops, slow_plain=True)
    # K10b takes the forward FFT of the polarized PBE fluxes
    _, _, _, fu, fd = k7g.gga_xc(nu, nd, gu, gd, PBE)
    boxes = torch.fft.fftn(torch.stack([fu, fd]).view((2, 3) + dims).to(
        torch.complex128), dim=(-3, -2, -1), norm="forward").view(2, 3, n)
    del fu, fd, gu, gd, g1, tu, td, tt
    gargs = (tables.gcart, tables.fft_index)
    # no single PyTorch call forms i G_c f and scatters it, or gathers and
    # sums it: library_ms null
    record("xc_gradient.gradient_boxes",
           [k10.gradient_boxes(fields, *gargs, n)],
           [k10.gradient_boxes_plain(fields, *gargs, n)],
           lambda: k10.gradient_boxes(fields, *gargs, n),
           lambda: k10.gradient_boxes_plain(fields, *gargs, n), None,
           nbytes=2 * ng * 16 + ng * 28 + 2 * 3 * n * 16,
           flops=2 * ng * 6.0)
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
    from sirius_tpu_torch.kernels import augmentation as k45
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

    # K4 on the four (rho, m_x, m_y, m_z) Hermitian component blocks;
    # yardstick: K4's einsum on four channels (phases and packed blocks
    # built outside the timing)
    aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                  dev)[0]
    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    a = (rng.standard_normal((4, nbeta, nbeta))
         + 1j * rng.standard_normal((4, nbeta, nbeta)))
    dm = torch.as_tensor((a + a.conj().transpose(0, 2, 1)) * 0.05, device=dev)
    targs = (aug["gidx"], aug["w"], aug["millers"], aug["pos"], aug["q"])
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    dmp = (aug["w"][None, None, :] * dm.reshape(4, -1)[:, aug["gidx"].long()].real
           ).to(torch.complex128)
    record("augmentation.rho_aug.4", [k45.rho_aug(dm, *targs)],
           [k45.rho_aug_plain(dm, *targs)],
           lambda: k45.rho_aug(dm, *targs),
           lambda: k45.rho_aug_plain(dm, *targs),
           lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, aug["q"]),
           nbytes=nqlm * ng * 16 + 4 * ng * 16 + ng * 12
           + 4 * nbeta * nbeta * 16,
           flops=ng * (na * (5.0 + 4 * nqlm * 4.0) + 4 * nqlm * 8.0))
    del ph, dmp

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
    from sirius_tpu_torch.kernels import veff_multiply as k1c
    from sirius_tpu_torch.kernels import xc_gradient as k10

    n = "launches"
    # every functional sum counts on its kernel's wrapper: each summary row
    # reads the count of the run that only launches its sum
    kernel = {"lda_xc": k7.lda_xc, "gga_xc": k7g.gga_xc,
              "mgga_xc": k7s.mgga_xc}
    xc = {name: (kernel[name.split(".")[0]], n) for name in XC_CHECKS}
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
           "augmentation.d_operator.4": (k45.d_operator, n)}
    for name in FP32_SUMMARY:
        out[name] = (out[base_name(name)][0],
                     "launches_" + name.rsplit(".", 1)[1])
    return out


# the kernels each SCF path must launch: the norm-conserving k-set path runs
# K1, K1c, K2, K3 and K7; ultrasoft + symmetry adds K4, K5 and K6. The Gamma
# path applies H through K8a, K1c real, K8b and solves with K2 float64 (the
# density keeps K1's scatter and K3); the chunked path adds K9 to the k-set
# path's kernels
NC_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
              "davidson_residual", "density_accumulate", "lda_xc",
              "veff_multiply")
US_KERNELS = NC_KERNELS + ("augmentation.rho_aug", "augmentation.d_operator",
                           "symmetrize_pw")
GAMMA_KERNELS = ("local_hpsi.pw_to_box", "density_accumulate", "lda_xc",
                 "gamma_pack.unpack_to_box", "gamma_pack.box_to_packed_hx",
                 "veff_multiply.real", "davidson_residual.f64")
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


def xc_kernels(base, gga: bool, axial: bool, mgga: bool = False) -> tuple:
    """A path's kernels for a deck of other functionals or spin: GGA runs
    K7g, K10a and K10b in place of K7, SCAN K7s, K10a, K10b, K11a and K11b;
    a polarized deck with symmetry runs K6 on its axial fields too."""
    out = tuple(k for k in base if not ((gga or mgga) and k == "lda_xc"))
    return out + (MGGA_KERNELS if mgga else GGA_KERNELS if gga else ()) + (
        ("symmetrize_pw.axial",) if axial else ())


# the band solve each deck of XC_DECKS takes, and the kernels it must launch
XC_DECK_PATH = {
    "pbe_us_sym": ("kset", xc_kernels(US_KERNELS, True, False)),
    "pw_us_sym_afm": ("kset", xc_kernels(US_KERNELS, False, True)),
    "gamma_pbe_us_sym_fm": ("gamma", xc_kernels(GAMMA_US_KERNELS, True, True)),
    "gamma_nc_vwn": ("gamma", GAMMA_KERNELS),
    "gamma_nc_pbesol": ("gamma", xc_kernels(GAMMA_KERNELS, True, False)),
    "scan_us_sym": ("kset", xc_kernels(US_KERNELS, False, False, mgga=True)),
    "scan_us_sym_fm": ("kset", xc_kernels(US_KERNELS, False, True,
                                          mgga=True)),
}
# the spinor k-set path: K1 over (band, spin) rows, K12a in place of K1c,
# K2 on the flattened spinors, K12b in place of K3, K4 and K5 on four
# channels, K6 on rho and V_eff and K6v on m and B with symmetry; LDA runs
# K7, PBE K7g, K10a and K10b
SPINOR_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
                  "davidson_residual", "spinor_veff", "density_accumulate_nc",
                  "lda_xc", "augmentation.rho_aug.4",
                  "augmentation.d_operator.4")
SPINOR_SYM_KERNELS = SPINOR_KERNELS + ("symmetrize_pw", "symmetrize_vector_pw")
SPINOR_DECK_PATH = {
    "small_spinor_us": SPINOR_KERNELS,
    "small_spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
    "spinor_us": SPINOR_KERNELS,
    "spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
}
FULL_GAMMA_PBE_FM_KERNELS = xc_kernels(GAMMA_US_KERNELS, True, True)
FULL_SCAN_KERNELS = xc_kernels(US_KERNELS, False, False, mgga=True)
# the fp32 paths: the band solve (and on the k-set path the density's
# transforms) through the fp32 instantiations, the rest of the iteration in
# fp64. The Gamma and chunked paths hand the density complex128 bands (K1's
# fp64 scatter and K3), as the JAX package does
FP32_US_KERNELS = ("local_hpsi.pw_to_box.c64", "local_hpsi.box_to_pw_hpsi.c64",
                   "veff_multiply.c64", "davidson_residual.c64",
                   "density_accumulate.c64", "lda_xc", "augmentation.rho_aug",
                   "augmentation.d_operator", "symmetrize_pw")
FP32_GAMMA_US_KERNELS = ("gamma_pack.unpack_to_box.f32",
                         "veff_multiply.real.c64",
                         "gamma_pack.box_to_packed_hx.f32",
                         "davidson_residual.f32", "local_hpsi.pw_to_box",
                         "density_accumulate", "lda_xc",
                         "augmentation.rho_aug", "augmentation.d_operator",
                         "symmetrize_pw")
FP32_CHUNKED_US_KERNELS = ("local_hpsi.pw_to_box.c64",
                           "local_hpsi.box_to_pw_hpsi.c64",
                           "veff_multiply.c64", "davidson_residual.c64",
                           "beta_chunk.c64", "local_hpsi.pw_to_box",
                           "density_accumulate", "lda_xc",
                           "augmentation.rho_aug", "augmentation.d_operator",
                           "symmetrize_pw")
FP32_SCAN_KERNELS = tuple(k for k in FP32_US_KERNELS if k != "lda_xc") + (
    "mgga_xc.scan", "xc_gradient.gradient_boxes", "xc_gradient.divergence_pw",
    "mgga_tau.grad_to_box.c64", "mgga_tau.box_to_pw_tau.c64")
FP32_SPINOR_SYM_KERNELS = ("local_hpsi.pw_to_box.c64",
                           "local_hpsi.box_to_pw_hpsi.c64",
                           "davidson_residual.c64", "spinor_veff.c64",
                           "density_accumulate_nc.c64",
                           "augmentation.rho_aug.4",
                           "augmentation.d_operator.4", "symmetrize_pw",
                           "symmetrize_vector_pw")
# the fp32 parity decks of the reference tool (each beside its fp64 twin
# there): the band solve each takes and the kernels it must launch
FP32_DECK_PATH = {
    "fp32_us_sym_polish": ("kset", FP32_US_KERNELS),
    "fp32_us_sym_fixed8": ("kset", FP32_US_KERNELS),
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
    """Fail unless every kernel of the path launched in this run. On the
    Gamma path H is applied without K1's gather: the run's gathers are the
    r -> G transforms only, one per potential (two polarized: V_xc and
    B_z) for iters + 1 potentials, and one per density (iters). On the CPU
    the wrappers take their plain versions and count nothing."""
    if dev.type != "cuda":
        return
    zero = [k for k in required if launches[k] <= 0]
    if zero:
        raise AssertionError(f"{phase}: kernels never launched: {zero}")
    gathers = launches["local_hpsi.box_to_pw_hpsi"]
    want = (2 if polarized else 1) * (iters + 1) + iters
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

    reset_launches()
    res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
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
          "launches": launches})
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
    if polarized and path == "kset_nc":
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
               path: str = "kset", with_rms: bool = False,
               electron_tol: float = 1e-8):
    """One full-width run with tolerances that cannot be met, its electron
    count held to electron_tol. Returns the launches, and with with_rms
    the density residual of each iteration too."""
    import torch

    from sirius_tpu_torch.dft.scf import run_scf

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with watch_band_solves() as solves:
        res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
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
          "band_solves": solves,
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
    return (launches, res["rms_history"]) if with_rms else launches


def xc_context(name: str):
    """The context of a 2-atom deck of XC_DECKS."""
    import numpy as np

    from sirius_tpu_torch.testing import synthetic_silicon_context

    spec, kind, params, moments = XC_DECKS[name]
    return synthetic_silicon_context(
        extra_params=dict(params), **kind, **spec,
        moments=None if moments is None else np.asarray(moments))


def magnetic_supercell_context(n: int, spec: dict, extra: dict, kind: dict,
                               moment):
    """The n x n x n supercell of the synthetic 2-atom cell with one
    starting moment on every atom: (0, 0, moment) for a number, else the
    vector (m_x, m_y, m_z). synthetic_silicon_context
    refuses moments with supercell > 1, so this tiles the positions and the
    moments itself, as that helper tiles positions, and builds the context
    the way the helper does."""
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
    vec = [0.0, 0.0, moment] if np.ndim(moment) == 0 else list(moment)
    moments = np.tile(np.asarray(vec, dtype=np.float64), (len(positions), 1))
    uc = ucm.UnitCell(
        lattice=lattice,
        atom_types=[synthetic_silicon_type(ultrasoft=kind["ultrasoft"])],
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
    ctx = synthetic_silicon_context(
        extra_params=dict(params), **kind, **spec,
        moments=None if moments is None else np.asarray(moments))
    tool.apply_control(ctx.cfg, control)
    return ctx


def single_k_context(name: str, spec: dict = GAMMA2):
    """The context of a 2-atom single-k parity deck (SINGLE_K)."""
    kind, params, control = SINGLE_K[name]
    ctx = make_context(spec, params, kind)
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    return ctx


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
    kern54.update(check_kernel_symmetrize("si54_supercell3_gamma", ctx54, dev,
                                          gpu))
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
    torch.cuda.empty_cache()
    parity_scf(ctx2, dev, refs["full_width_2atom"], gpu)
    full_width(ctx16, dev, gpu)
    parity_scf(ctx2us, dev, refs["full_width_2atom_us_sym"], gpu,
               phase="parity_scf_us", deck="full_width_2atom_us_sym",
               required=US_KERNELS)
    launches, rms64 = full_width(ctx16us, dev, gpu, phase="full_width_us",
                                 required=US_KERNELS, with_rms=True)
    # the same run on the fp32 path, polished to fp64 after iteration 3 or 4
    ctx16us.cfg.parameters.precision_wf = "fp32"
    ctx16us.cfg.settings.fp32_to_fp64_rms = polish_threshold(rms64)
    # (its two fp64 iterations still mix the fp32 iterations' densities,
    # so its electron count is held as an fp32 run's)
    runs_fp32 = {"full_width_us_fp32": full_width(
        ctx16us, dev, gpu, phase="full_width_us_fp32",
        required=FP32_US_KERNELS, deck="si16_supercell2_us_sym",
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
    runs = {}
    for name, ctx in xc_decks.items():
        path, required = XC_DECK_PATH[name]
        runs[name] = parity_scf(
            ctx, dev, refs[name], gpu,
            phase="parity_scf_" + name.replace("_sym", ""), deck=name,
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
    launches_mgga = {name: runs[deck][name]
                     for name, deck in SUMMARY_MGGA.items()}
    kern_mgga = {name: kern_mgga[name] for name in launches_mgga}
    launches_xc = {name: runs[deck][name] for name, deck in SUMMARY_XC.items()}
    launches_xc.update({name: runs["full_width_gamma_pbe_fm"][name] for name in
                        ("xc_gradient.gradient_boxes",
                         "xc_gradient.divergence_pw", "symmetrize_pw.axial")})
    kern54xc = {name: kern54xc[name] for name in launches_xc}

    summary = []
    launches_fp32 = {name: runs_fp32[run][name]
                     for name, run in FP32_SUMMARY.items()}
    for records, counts in ((kern16, launches), (kern54, launches54),
                            (kern54xc, launches_xc),
                            (kern_mgga, launches_mgga),
                            (kern_spinor, launches_spinor),
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
