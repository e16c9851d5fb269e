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
   on four channels): error,
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
   Gamma, NC, a fixed 14 iterations; parity_scf_scan_us and
   parity_scf_scan_us_fm: SCAN on the k-point US + symmetry deck,
   unpolarized and +0.5 / +0.5), and the non-collinear decks of the spinor
   k-set solve (parity_scf_small_spinor_us and
   parity_scf_small_spinor_pbe_us_sym, magnetic; parity_scf_spinor_us and
   parity_scf_spinor_pbe_us_sym at the parity shape, which relax to no
   moment; spinor_moment_errors says what of the moments is compared),
   against the JAX package's recorded energies and moments
   (sirius_tpu_torch/data/jax_reference.json);
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
   magnetic ops and 4 k-points (full_width_spinor_us, 4 iterations); kernel
   launches per iteration, peak device memory, electron count, total
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
parity_scf_gamma_nc_pbesol, parity_scf_scan_us_fm).

The last three lines are the kernels summary, the nvidia-smi name/power
line and {"ok": true, "device": {...}}. Any failure exits non-zero before
the ok line; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory and fp64 outside the
# tensor cores, the rate of these kernels' elementwise fp64 work
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12

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
# a fixed 14 iterations, see tools/torch_port_reference.py), control
SINGLE_K = {
    "gamma_nc": (NC, {"num_dft_iter": 14, **RUN_TO_END}, {}),
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
                     {"num_dft_iter": 14, **RUN_TO_END,
                      "xc_functionals": ["XC_LDA_X", "XC_LDA_C_VWN"]}, None),
    "gamma_nc_pbesol": (GAMMA2, NC,
                        {"num_dft_iter": 14, **RUN_TO_END,
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
# spinor_context); the full-width one takes their canted moment
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
       "symmetrize_vector_pw": 1e-13, "augmentation.rho_aug.4": 1e-12}
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
}
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP64_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(a, b) -> tuple[float, float]:
    import torch

    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / scale if scale > 0 else err


def record_kernel(out, deck, gpu, name, kernel_out, plain_out, fn_k, fn_p,
                  fn_lib, nbytes, flops, slow_plain=False):
    """Compare one kernel with its plain version, time both (and the
    library yardstick), emit the record and keep it in out[name]."""
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)
            if a is not None]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ms = time_ms(fn_k)
    # a plain version that loops in Python is timed over fewer samples
    plain_ms = (time_ms(fn_p, samples=5, inner=1, warm=1) if slow_plain
                else time_ms(fn_p))
    lib_ms = time_ms(fn_lib) if fn_lib is not None else None
    b_ms, b_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "deck": deck, "name": name, "gpu": gpu,
           "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": TOL[name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    emit(rec)
    if not rel <= TOL[name]:
        raise AssertionError(f"{name} at {deck}: rel err {rel} > {TOL[name]}")
    out[name] = rec


def make_context(spec: dict, extra: dict | None = None, kind: dict = NC):
    from sirius_tpu_torch.testing import synthetic_silicon_context

    return synthetic_silicon_context(extra_params=dict(extra or {}), **kind,
                                     **spec)


def check_kernels(deck: str, ctx, dev, gpu: str) -> dict:
    """Each kernel against its plain version at this deck's main-path
    shapes. Returns {kernel: record}."""
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
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)
    ps = make_hkset_params(ctx, pot.veff_r_coarse.cpu().numpy(), device=dev)
    hk = ps.hk()
    mask = hk.mask
    psi_np = (rng.standard_normal((nk, nb, ngk))
              + 1j * rng.standard_normal((nk, nb, ngk)))
    psi = torch.as_tensor(psi_np, device=dev)  # padded lanes hold garbage
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
        z = torch.zeros((nk * nb, n), dtype=torch.complex128, device=dev)
        return z.index_put_((rows, cols), vals)

    record("local_hpsi.pw_to_box", [box_k], [box_p],
           lambda: k1.pw_to_box(psi, idx, mask, n),
           lambda: k1.pw_to_box_plain(psi, idx, mask, n), lib_scatter,
           nbytes=nk * nb * ngk * 16 + nk * ngk * 12 + nk * nb * n * 16,
           flops=0.0)
    del box_p

    # K1b: box -> sphere gather fused with ekin*psi and the mask
    vbox = torch.fft.fftn(box_k.view((nk, nb) + dims), dim=(-3, -2, -1)).view(nk, nb, n)
    del box_k
    h_k = k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx)
    h_p = k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx)
    gidx = idx.long()[:, None, :].expand(nk, nb, ngk)
    record("local_hpsi.box_to_pw_hpsi", list(h_k), list(h_p),
           lambda: k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx),
           lambda: k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx),
           lambda: torch.gather(vbox, 2, gidx),
           nbytes=nk * nb * ngk * (16 + 16 + 32) + nk * ngk * 20,
           flops=nk * nb * ngk * 8.0)
    del vbox, h_k, h_p

    # K2: residual + preconditioner on a real (x, Hx, Sx); row 0 of each
    # k-point is an exact eigenpair so the converged branch is exercised
    x = psi * mask[:, None, :]
    hx, sx = apply_h_s(hk, x)
    hx[:, 0] = 2.0 * sx[:, 0]
    hd = ps.h_diag.reshape(nk, ngk)
    od = ps.o_diag
    r_k = k2.davidson_residual(x, hx, sx, hd, od, mask, 1e-6)
    r_p = k2.davidson_residual_plain(x, hx, sx, hd, od, mask, 1e-6)
    if not bool((r_k[1][:, 0] < 1e-6).all()):
        raise AssertionError("davidson_residual: eigenpair rows not converged")
    record("davidson_residual", list(r_k), list(r_p),
           lambda: k2.davidson_residual(x, hx, sx, hd, od, mask, 1e-6),
           lambda: k2.davidson_residual_plain(x, hx, sx, hd, od, mask, 1e-6),
           None,
           nbytes=nk * nb * ngk * (48 + 16) + nk * ngk * 24 + nk * nb * 16,
           flops=nk * nb * ngk * 30.0)
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
    record("density_accumulate", [a_k], [a_p],
           lambda: k3.density_accumulate(acc_t, fr, occ, float(n) ** 2),
           lambda: k3.density_accumulate_plain(acc_t, fr, occ, float(n) ** 2),
           None, nbytes=nb * n * 16 + n * 16 + nb * 8, flops=nb * n * 4.0)
    del fr

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


def check_kernels_us(deck: str, ctx, dev, gpu: str) -> dict:
    """K1c, K4, K5 and K6 against their plain versions at an ultrasoft +
    symmetry deck's main-path shapes. Returns {kernel: record}."""
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
    veff = pot.veff_r_coarse.reshape(1, n)
    fr0 = torch.complex(torch.randn(nk, rows, n, dtype=torch.float64, device=dev),
                        torch.randn(nk, rows, n, dtype=torch.float64, device=dev))
    fr_k = k1c.veff_multiply(fr0.clone(), veff)
    fr_p = k1c.veff_multiply_plain(fr0.clone(), veff)
    fr_t = fr0.clone()
    record("veff_multiply", [fr_k], [fr_p],
           lambda: k1c.veff_multiply(fr_t, veff),
           lambda: k1c.veff_multiply_plain(fr_t, veff),
           lambda: fr_t.mul_(veff[None]),
           nbytes=nk * rows * n * 32 + n * 8, flops=nk * rows * n * 2.0)
    del fr0, fr_k, fr_p, fr_t

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
    v = pot.veff_g.contiguous()
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=dev)
    dargs = (aug["millers"], aug["pos"], aug["q"], aug["gidx"], aug["lo_idx"],
             aug["lo_mask"], omega)
    d_t = dion.clone()
    record("augmentation.d_operator",
           [k45.d_operator(v, *dargs, dion.clone())],
           [k45.d_operator_plain(v, *dargs, dion.clone())],
           lambda: k45.d_operator(v, *dargs, d_t),
           lambda: k45.d_operator_plain(v, *dargs, d_t),
           lambda: torch.einsum("qg,g,ga->aq", aug["q"], v.conj(), ph),
           nbytes=nqlm * ng * 16 + ng * 16 + ng * 12 + 2 * nbeta * nbeta * 8,
           flops=ng * na * (5.0 + 2.0 + 6.0 + nqlm * 4.0))
    del ph, dmp

    # K6: the rho_new symmetrization of the SCF (a scalar field), on the
    # initial density; yardstick: index_add_ over the JAX package's dense
    # per-op scatter table
    tb = tables.sym if tables.sym is not None else build_sym_pw_tables(ctx, dev)
    f = rho0.contiguous()
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.dims)
    nops = tb.num_ops
    n1, n2, n3 = tb.dims
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

    record("symmetrize_pw", [k6.symmetrize_pw(f, *sargs)],
           [k6.symmetrize_pw_plain(f, *sargs)],
           lambda: k6.symmetrize_pw(f, *sargs),
           lambda: k6.symmetrize_pw_plain(f, *sargs), lib_sym,
           nbytes=ng * (16 + 12 + 16) + n1 * n2 * n3 * 4 + nops * 60,
           flops=nops * ng * 15.0, slow_plain=True)
    del idx, vals
    return out


def check_kernels_gamma(deck: str, ctx, dev, gpu: str) -> dict:
    """K8a, K8b, K1c in real mode and K2 on float64 blocks against their
    plain versions at a Gamma deck's main-path shapes: one application to
    the packed [X; P] block of the band solve (R = 2 nb) and one residual
    of the nb-row block. Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import gamma_pack as k8
    from sirius_tpu_torch.kernels import veff_multiply as k1c
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
    gp = make_gamma_params(ctx, pot.veff_r_coarse.cpu().numpy(), gm,
                           device=dev)
    npair = int(gp.rep_box.shape[0])
    rows = 2 * nb
    x = torch.as_tensor(rng.standard_normal((1, rows, ngk)), device=dev)
    utabs = (gp.mask_p, gp.slot_re, gp.slot_im, gp.im_sign, gp.scale,
             gp.fft_index)

    # K8a: packed real -> complex box (zero fill and scatter)
    box = k8.unpack_to_box(x, *utabs, n)
    record("gamma_pack.unpack_to_box", [box],
           [k8.unpack_to_box_plain(x, *utabs, n)],
           lambda: k8.unpack_to_box(x, *utabs, n),
           lambda: k8.unpack_to_box_plain(x, *utabs, n), None,
           nbytes=rows * ngk * 8 + ngk * 36 + rows * n * 16,
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
    record("veff_multiply.real", [fr_k],
           [k1c.veff_multiply_real_plain(fr0, veff)],
           lambda: k1c.veff_multiply_real(fr_t, veff),
           lambda: k1c.veff_multiply_real_plain(fr_t, veff),
           lambda: fr_v.mul_(vz),
           nbytes=rows * n * (8 + 16) + n * 8, flops=rows * n * 1.0)
    del fr0, fr_t, fr_v, vz

    # K8b: the forward transform gathered back into the packed slots
    vbox = torch.fft.fftn(fr_k.view((1, rows) + dims),
                          dim=(-3, -2, -1)).view(1, rows, n)
    del fr_k
    pargs = (gp.ekin_p, gp.mask_p, gp.rep_box, gp.par_box, gp.zero_box)
    record("gamma_pack.box_to_packed_hx",
           list(k8.box_to_packed_hx(vbox, x, *pargs)),
           list(k8.box_to_packed_hx_plain(vbox, x, *pargs)),
           lambda: k8.box_to_packed_hx(vbox, x, *pargs),
           lambda: k8.box_to_packed_hx_plain(vbox, x, *pargs), None,
           nbytes=(rows * (2 * npair + 1) * 16 + rows * ngk * (8 + 16)
                   + ngk * 16 + npair * 8),
           flops=rows * ngk * 6.0)
    del vbox

    # K2 on float64 blocks: x, H x, S x of the packed operator; row 0 an
    # exact eigenpair so the converged branch is exercised
    xs = x[:, :nb] * gp.mask_p
    hx, sx = apply_h_s_gamma(gp, xs)
    hx[:, 0] = 2.0 * sx[:, 0]
    hd = torch.as_tensor(rng.uniform(1.0, 3.0, (1, ngk)), device=dev)
    od = torch.ones((1, ngk), dtype=torch.float64, device=dev)
    mask = gp.mask_p[None]
    r_k = k2.davidson_residual(xs, hx, sx, hd, od, mask, 1e-6)
    if not bool((r_k[1][:, 0] < 1e-6).all()):
        raise AssertionError("davidson_residual.f64: eigenpair row not converged")
    record("davidson_residual.f64", list(r_k),
           list(k2.davidson_residual_plain(xs, hx, sx, hd, od, mask, 1e-6)),
           lambda: k2.davidson_residual(xs, hx, sx, hd, od, mask, 1e-6),
           lambda: k2.davidson_residual_plain(xs, hx, sx, hd, od, mask, 1e-6),
           None, nbytes=nb * ngk * (24 + 8) + ngk * 24 + nb * 16,
           flops=nb * ngk * 15.0)
    return out


def check_kernel_chunk(deck: str, ctx, chunk: int, dev, gpu: str) -> dict:
    """K9 against its plain version for the first chunk step of a
    chunked-projector deck (chunk atoms a step). Returns {kernel: record}."""
    import torch

    from sirius_tpu_torch.kernels import beta_chunk as k9
    from sirius_tpu_torch.ops.beta_chunked import make_chunked_hk

    prm = make_chunked_hk(ctx, 0, chunk=chunk, device=dev)
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
    record_kernel(out, deck, gpu, "beta_chunk", [k9.beta_chunk(*args)],
                  [k9.beta_chunk_plain(*args)],
                  lambda: k9.beta_chunk(*args),
                  lambda: k9.beta_chunk_plain(*args), None,
                  nbytes=(c * nxi * ngk * 16 + ngk * (8 + 8 + 24 + lmmax * 8)
                          + nrf * nread * 8 + c * (24 + nxi * 24)),
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


def check_kernels_tau(deck: str, ctx, dev, gpu: str) -> dict:
    """K11a and K11b against their plain versions at this deck's band-solve
    shapes: one component of the tau operator applied to the Davidson step's
    block [nk, nb, ngk], with non-zero values on the padded lanes (they
    point at the G = 0 slot). K11b adds its three components into H psi in
    order, the last one timed (it gathers the box and reads and writes
    hpsi). Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.kernels import mgga_tau as k11
    from sirius_tpu_torch.parallel.batched import make_hkset_params

    nk, nb, ngk = ctx.gkvec.num_kpoints, ctx.num_bands, ctx.gkvec.ngk_max
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    rng = np.random.default_rng(23)
    hk = make_hkset_params(ctx, np.zeros(dims), device=dev).hk()
    mask, idx = hk.mask, hk.fft_index
    gkc = torch.as_tensor(np.asarray(ctx.gkvec.gkcart, dtype=np.float64),
                          device=dev)
    psi = torch.as_tensor(rng.standard_normal((nk, nb, ngk))
                          + 1j * rng.standard_normal((nk, nb, ngk)),
                          device=dev)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)

    # yardstick: the scatter as one index_put_ into a zeroed box
    bi, gi = torch.nonzero(mask > 0, as_tuple=True)
    rows = (bi[:, None] * nb
            + torch.arange(nb, device=dev)[None, :]).reshape(-1)
    cols = idx[bi, gi].long().repeat_interleave(nb)
    vals = (gkc[bi, gi, 1][:, None] * psi.permute(0, 2, 1)[bi, gi]).reshape(-1)

    def lib_scatter():
        z = torch.zeros((nk * nb, n), dtype=torch.complex128, device=dev)
        return z.index_put_((rows, cols), vals)

    args = (psi, gkc, 1, idx, mask, n)
    record("mgga_tau.grad_to_box", [k11.grad_to_box(*args)],
           [k11.grad_to_box_plain(*args)],
           lambda: k11.grad_to_box(*args),
           lambda: k11.grad_to_box_plain(*args), lib_scatter,
           nbytes=nk * nb * ngk * 16 + nk * ngk * 20 + nk * nb * n * 16,
           flops=nk * nb * ngk * 2.0)
    del vals, rows, cols

    boxes = [k11.grad_to_box(psi, gkc, c, idx, mask, n) for c in range(3)]
    h0 = torch.as_tensor(rng.standard_normal((nk, nb, ngk))
                         + 1j * rng.standard_normal((nk, nb, ngk)), device=dev)

    def run(fn):
        h = h0.clone()
        for c in range(3):
            fn(boxes[c], gkc, c, idx, mask, h)
        return h

    h_t = run(k11.box_to_pw_tau)
    gidx = idx.long()[:, None, :].expand(nk, nb, ngk)
    record("mgga_tau.box_to_pw_tau", [run(k11.box_to_pw_tau)],
           [run(k11.box_to_pw_tau_plain)],
           lambda: k11.box_to_pw_tau(boxes[2], gkc, 2, idx, mask, h_t),
           lambda: k11.box_to_pw_tau_plain(boxes[2], gkc, 2, idx, mask, h_t),
           lambda: torch.gather(boxes[2], 2, gidx),
           nbytes=nk * nb * ngk * (16 + 32) + nk * ngk * 20,
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
    ng, nops = f.shape[0], tb.num_ops
    n1, n2, n3 = tb.dims
    out = {}
    record_kernel(out, deck, gpu, "symmetrize_pw.axial",
                  [k6.symmetrize_pw(f, *sargs)],
                  [k6.symmetrize_pw_plain(f, *sargs)],
                  lambda: k6.symmetrize_pw(f, *sargs),
                  lambda: k6.symmetrize_pw_plain(f, *sargs), None,
                  nbytes=ng * (16 + 12 + 16) + n1 * n2 * n3 * 4 + nops * 68,
                  flops=nops * ng * 16.0, slow_plain=True)
    return out


def check_kernels_spinor(deck: str, ctx, dev, gpu: str) -> dict:
    """K12a, K12b, K6v and K4 on four channels against their plain versions
    at a non-collinear deck's main-path shapes: the spinor potential of the
    initial density and magnetization on the k-set's [nk nb, 2, n] box (a
    Davidson step's block), the four-component density of one k-point's
    [nb, 2, n] box, the axial-vector symmetrization of the initial B field
    over the magnetic group, rho_aug of four Hermitian component blocks.
    Returns {kernel: record}."""
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
    v = pot.veff_boxes.view(4, n)

    # K12a: in place on [nk nb, 2, n], the whole k-set's block of a
    # Davidson step (22 of the 25 launches of an iteration; the three
    # [X; P] refreshes take twice the rows). Yardstick: one einsum of the
    # [2, 2, n] complex potential, built outside the timing, with the box
    rows = nk * nb
    fr0 = torch.complex(torch.randn(rows, 2, n, dtype=torch.float64,
                                    device=dev),
                        torch.randn(rows, 2, n, dtype=torch.float64,
                                    device=dev))
    fr_k = k12a.spinor_veff(fr0.clone(), *v)
    fr_p = k12a.spinor_veff_plain(fr0.clone(), *v)
    fr_t = fr0.clone()
    vmat = spinor_potential_matrix(*v)
    record("spinor_veff", [fr_k], [fr_p],
           lambda: k12a.spinor_veff(fr_t, *v),
           lambda: k12a.spinor_veff_plain(fr_t, *v),
           lambda: torch.einsum("sti,rti->rsi", vmat, fr0),
           nbytes=rows * 2 * n * 32 + 4 * n * 8, flops=rows * n * 20.0)
    del fr_k, fr_p, fr_t

    # K12b: the four fields of one k-point's box (one launch per k-point)
    fr1 = fr0[:nb]
    occ = torch.as_tensor(rng.uniform(0.0, 0.25, nb), device=dev)
    acc0 = torch.as_tensor(rng.uniform(0.0, 1.0, (4, n)), device=dev)
    acc_t = acc0.clone()
    record("density_accumulate_nc",
           [k12b.density_accumulate_nc(acc0.clone(), fr1, occ, float(n) ** 2)],
           [k12b.density_accumulate_nc_plain(acc0.clone(), fr1, occ,
                                             float(n) ** 2)],
           lambda: k12b.density_accumulate_nc(acc_t, fr1, occ, float(n) ** 2),
           lambda: k12b.density_accumulate_nc_plain(acc_t, fr1, occ,
                                                    float(n) ** 2),
           None, nbytes=nb * 2 * n * 16 + 4 * n * 16 + nb * 8,
           flops=nb * n * 20.0 + n * 12.0)
    del fr0, fr1, acc_t

    # K6v: the unsymmetrized B field of the initial potential; yardstick:
    # index_add_ over the JAX package's dense per-op scatter table, with the
    # rotated and phased values built outside the timing
    tb = tables.sym if tables.sym is not None else build_sym_pw_tables(ctx,
                                                                       dev)
    f = pot.bvec_g.contiguous()
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.srot, tb.dims)
    nops = tb.num_ops
    n1, n2, n3 = tb.dims
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

    record("symmetrize_vector_pw", [k6.symmetrize_vector_pw(f, *sargs)],
           [k6.symmetrize_vector_pw_plain(f, *sargs)],
           lambda: k6.symmetrize_vector_pw(f, *sargs),
           lambda: k6.symmetrize_vector_pw_plain(f, *sargs), lib_sym,
           nbytes=ng * (48 + 12 + 48) + n1 * n2 * n3 * 4 + nops * 132,
           flops=nops * ng * 60.0, slow_plain=True)
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
    holds its launch count (K2 counts its float64 launches apart)."""
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
    return {"local_hpsi.pw_to_box": (k1.pw_to_box, n),
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
            "augmentation.rho_aug.4": (k45.rho_aug, n)}


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
# K2 on the flattened spinors, K12b in place of K3, K4 on four channels, K5
# four times an iteration, K6 on rho and V_eff and K6v on m and B with
# symmetry; LDA runs K7, PBE K7g, K10a and K10b
SPINOR_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
                  "davidson_residual", "spinor_veff", "density_accumulate_nc",
                  "lda_xc", "augmentation.rho_aug.4",
                  "augmentation.d_operator")
SPINOR_SYM_KERNELS = SPINOR_KERNELS + ("symmetrize_pw", "symmetrize_vector_pw")
SPINOR_DECK_PATH = {
    "small_spinor_us": SPINOR_KERNELS,
    "small_spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
    "spinor_us": SPINOR_KERNELS,
    "spinor_pbe_us_sym": xc_kernels(SPINOR_SYM_KERNELS, True, False),
}
FULL_GAMMA_PBE_FM_KERNELS = xc_kernels(GAMMA_US_KERNELS, True, True)
FULL_SCAN_KERNELS = xc_kernels(US_KERNELS, False, False, mgga=True)


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
    if abs(res["num_scf_iterations"] - ref["num_scf_iterations"]) > 1:
        raise AssertionError(f"{phase}: iteration count differs by more than 1")
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
               path: str = "kset") -> dict:
    import torch

    from sirius_tpu_torch.dft.scf import run_scf

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    iters = res["num_scf_iterations"]
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
          "band_solve_seconds": res["band_solve_seconds"],
          # after the first iteration, which carries the LCAO start
          "band_solve_share": (sum(res["band_solve_seconds"][1:])
                               / max(sum(res["iteration_seconds"][1:]), 1e-30)),
          "launches": launches,
          "launches_per_iteration": {k: v / iters for k, v in launches.items()},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "electrons": nel, "e_total": res["energy"]["total"],
          "total_moment": res.get("magnetisation", {}).get("total", [0.0] * 3),
          "energies_finite": e_ok})
    if iters != FULL_ITERS[phase]:
        raise AssertionError(f"{phase}: {iters} iterations, want "
                             f"{FULL_ITERS[phase]}")
    if not e_ok:
        raise AssertionError(f"{phase}: non-finite energy")
    if abs(nel - want_nel) > 1e-8:
        raise AssertionError(f"{phase}: electron count {nel}, want {want_nel}")
    check_launched(phase, dev, launches, required, path, iters,
                   ctx.num_mag_dims == 1)
    return launches


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


def spinor_context(name: str, tool=None):
    """The context of a non-collinear deck of the reference tool."""
    import numpy as np

    from sirius_tpu_torch.testing import synthetic_silicon_context

    spec, kind, _, params, moments = (tool or reference_tool()).deck_spec(name)
    return synthetic_silicon_context(extra_params=dict(params), **kind,
                                     **spec, moments=np.asarray(moments))


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
    spinor = {name: spinor_context(name, tool) for name in tool.SPINOR_DECKS}
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
    torch.cuda.empty_cache()
    parity_scf(ctx2, dev, refs["full_width_2atom"], gpu)
    full_width(ctx16, dev, gpu)
    parity_scf(ctx2us, dev, refs["full_width_2atom_us_sym"], gpu,
               phase="parity_scf_us", deck="full_width_2atom_us_sym",
               required=US_KERNELS)
    launches = full_width(ctx16us, dev, gpu, phase="full_width_us",
                          required=US_KERNELS)
    for name, ctx in single.items():
        path, required = SINGLE_K_PATH[name]
        parity_scf(ctx, dev, refs[name], gpu,
                   phase="parity_scf_" + name.replace("_sym", ""), deck=name,
                   required=required, path=path)
    torch.cuda.empty_cache()
    launches54 = full_width(ctx54, dev, gpu, phase="full_width_gamma_us",
                            required=GAMMA_US_KERNELS,
                            deck="si54_supercell3_gamma", path="gamma")
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
    del ctx16nc
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
    for records, counts in ((kern16, launches), (kern54, launches54),
                            (kern54xc, launches_xc),
                            (kern_mgga, launches_mgga),
                            (kern_spinor, launches_spinor)):
        for name, rec in records.items():
            summary.append({
                "name": name, "route": "cuda", "source": SOURCE[name],
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
