"""SCF ground-state driver (reference: src/dft/dft_ground_state.cpp find
:178-427 and the sirius.scf mini-app output JSON).

Mirrors the host path of sirius_tpu/dft/scf.py::_run_scf_inner for the
configurations of the port: unpolarized, collinear spin-polarized
(num_mag_dims 1) or non-collinear (num_mag_dims 3, handed to
dft/scf_nc.py::run_scf_nc as the JAX package hands it at scf.py:244-259),
norm-conserving or ultrasoft plane-wave pseudopotentials
on a k-mesh, with or without the space group (irreducible k-mesh,
symmetrized density, magnetization and potential; the magnetic subgroup
and its spin-flip ops), any sum of the LDA, PBE-family GGA and SCAN
meta-GGA functionals, any mixer of dft/mixer.py on [rho; m]. Species are
read from SIRIUS species JSON or UPF files (run_scf_from_file, the
sirius.scf mini-app on a deck file; cli.py).
Orchestration is host Python; the band solve, density, mixing and
potential run on tensors on ``device``, which is the GPU unless the
caller asks for the CPU.

The band solve takes one of three paths, chosen as the JAX package chooses
on one device (scf.py:676-713): the chunked-projector solve
(ops/beta_chunked.py) for a single k-point whose dense projector table is
over budget or when control.beta_chunked forces it, else the Gamma
packed-real solve (ops/gamma.py, one spin at a time) for a Gamma-only deck
with control.reduce_gvec, else the batched k-set solve over every (k, spin)
(parallel/batched.py). A meta-GGA deck always takes the k-set solve, with
the tau term in the operator (ops/mgga.py), as in the JAX package.

precision_wf = "fp32" runs the band solve (the wave functions, the H and S
applications, the Davidson residual and the subspace algebra) in complex64
with float32 tables, on every path; the density, the density matrix, the
potential, XC, D, the symmetrization and the mixer stay fp64, as in the JAX
package (scf.py:266). settings.fp32_to_fp64_rms > 0 switches the band solve
to complex128 once the density residual falls below it, and then runs at
least one fp64 iteration before convergence may be declared
(scf.py:2200-2212).
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from sirius_tpu_torch.config.schema import Config, load_config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.device import resolve_device, synchronize
from sirius_tpu_torch.dft.density import (
    atomic_moments,
    build_dm_sym_tables,
    density_from_coarse_acc,
    grid_tables,
    initial_density_g,
    initial_magnetization_g,
    rho_real_space,
    symmetrize_density_matrix_device,
    symmetrize_pw,
    symmetrize_tau,
)
from sirius_tpu_torch.dft.fused import (
    S_BXC,
    S_E1,
    S_E2,
    S_EHA,
    S_ENT,
    S_EVAL,
    S_EXC,
    S_FINITE,
    S_MAG,
    S_RMS,
    S_VHA,
    S_VXC,
    FusedScf,
    read_record,
)
from sirius_tpu_torch.dft.mixer import Mixer, schedule_res_tol
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.dft.potential import energies_host, generate_potential
from sirius_tpu_torch.dft.recovery import ScfSupervisor
from sirius_tpu_torch.dft.scf_nc import run_scf_nc
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.io.checkpoint import (
    find_resumable,
    load_state,
    save_state,
)
from sirius_tpu_torch.ops.atomic import atomic_orbitals
from sirius_tpu_torch.ops.augmentation import (
    build_aug_device_tables,
    d_operator_device,
    rho_aug_g_device,
)
from sirius_tpu_torch.ops.beta_chunked import (
    apply_h_s_chunked,
    make_chunked_hk,
    pack_dmat_chunks,
)
from sirius_tpu_torch.ops.gamma import (
    apply_h_s_gamma,
    build_gamma_map,
    davidson_gamma,
    make_gamma_params,
    pack,
    pack_diags,
    unpack_device,
)
from sirius_tpu_torch.ops.hamiltonian import astype, real_dtype_of
from sirius_tpu_torch.ops.mgga import davidson_kset_mgga, tau_kset
from sirius_tpu_torch.parallel.batched import (
    compute_h_diag,
    compute_o_diag,
    davidson_kset,
    density_kset,
    density_matrix_kset,
    initialize_subspace_kset,
    make_hkset_params,
)
from sirius_tpu_torch.solvers.davidson import (
    davidson,
    num_applies,
    residual_health,
    subspace_rotate,
)
from sirius_tpu_torch.utils import checksums, devfail, faults
from sirius_tpu_torch.utils.profiler import profile, reset_timers, timer_report


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration this port slice does
    not cover, naming the ROADMAP item that brings it. Nothing outside the
    slice is computed differently in its place."""
    p = cfg.parameters
    if p.electronic_structure_method != "pseudopotential":
        raise NotImplementedError(
            f"{p.electronic_structure_method}: FP-LAPW comes with ROADMAP "
            "queue 1, item 11")
    if p.precision_wf not in ("fp32", "fp64"):
        raise ValueError(f"precision_wf must be fp32 or fp64, got '{p.precision_wf}'")
    if p.num_mag_dims not in (0, 1, 3):
        raise ValueError(f"num_mag_dims must be 0, 1 or 3, got {p.num_mag_dims}")
    if p.hubbard_correction or cfg.hubbard.local or cfg.hubbard.nonlocal_:
        raise NotImplementedError("Hubbard corrections: ROADMAP queue 1, item 8")
    XCFunctional(p.xc_functionals)  # raises for an unknown name
    if cfg.control.straggler_detect in (True, "true", "on", "force"):
        raise NotImplementedError(
            "control.straggler_detect: the straggler watchdog reads the "
            "card's peak from obs/costs.py, which comes with ROADMAP queue "
            "1, item 12")
    if (cfg.control.print_stress and p.num_mag_dims != 3
            and XCFunctional(p.xc_functionals).is_mgga):
        # raised before the SCF, where the JAX package raises after it
        # (scf.py:2392-2399): the tau term of the stress is not there
        raise NotImplementedError("stress with mGGA is not implemented")


def check_context(cfg: Config, ctx: SimulationContext) -> None:
    """The context-level half of check_supported: species and k-set."""
    if any(t.pseudo_type == "PAW" or t.paw for t in ctx.unit_cell.atom_types):
        raise NotImplementedError(
            "PAW species need the on-site PAW terms (ROADMAP queue 1, "
            "item 8); ultrasoft and norm-conserving species run")


def band_solve_path(cfg: Config, ctx: SimulationContext) -> str:
    """"kset_nc", "chunked", "gamma" or "kset": the band solve the JAX
    package takes for this deck on one device (scf.py:244-259, :676-713;
    Hubbard and PAW, which also decide there, are refused before this).
    A non-collinear context (num_mag_dims 3) takes the spinor k-set solve
    whatever its k-set: the JAX package hands it to run_scf_nc before the
    Gamma and chunked branches.
    A meta-GGA deck takes the k-set solve, whatever its k-set and control
    (scf.py:689, :709: the tau operator is complex and per k-point).
    Otherwise the chunked branch is tested first: a single unpolarized
    k-point with projectors, taken when control.beta_chunked forces it or,
    on "auto", when the dense [nbeta, ngk] complex table exceeds
    control.beta_chunk_budget_bytes. Else a Gamma-only k-set with
    control.reduce_gvec takes the packed-real path, one spin at a time."""
    if ctx.num_mag_dims == 3:
        return "kset_nc"
    if XCFunctional(cfg.parameters.xc_functionals).is_mgga:
        return "kset"
    c = cfg.control
    nk = ctx.gkvec.num_kpoints
    nbeta = ctx.beta.num_beta_total
    flag = c.beta_chunked
    if (flag not in (False, "false", "off") and nk == 1
            and ctx.num_spins == 1 and nbeta):
        foot = nbeta * ctx.gkvec.ngk_max * 16
        if flag in (True, "force") or (
                flag == "auto" and foot > c.beta_chunk_budget_bytes):
            return "chunked"
    if (c.reduce_gvec and nk == 1
            and float(np.abs(np.asarray(ctx.gkvec.kpoints[0])).max()) < 1e-12):
        return "gamma"
    return "kset"


def fuses(cfg: Config, ctx: SimulationContext) -> bool:
    """Whether the JAX package runs this deck's loop as its fused device
    step on one device (sirius_tpu/dft/scf.py:848-855): the k-set band
    solve, no mGGA, a linear or Anderson mixer (broyden1 mixes as Anderson
    there, mixer.py:66; anderson_stable and broyden2 take the host loop),
    control.device_scf not off and no SIRIUS_TPU_PRINT_CHECKSUM tracing
    (utils/checksums.py, whose sums the host loop takes). run_scf then
    runs dft/fused.py's step, and the forces and stress take the D of the
    final mixed potential (fused.py:387-390); the host loop hands them the
    D its last band solve used (scf.py:1236-1246)."""
    return (cfg.control.device_scf not in (False, "false", "off")
            and not checksums.enabled()
            and band_solve_path(cfg, ctx) == "kset"
            and not XCFunctional(cfg.parameters.xc_functionals).is_mgga
            and cfg.mixer.type in ("linear", "anderson", "broyden1"))


def _initial_subspace(ctx: SimulationContext) -> np.ndarray:
    """LCAO + random-fill initial trial vectors [nk, nspin, nbig, ngk] on the
    host, nbig = max(num_bands, num_atomic_orbitals) (reference
    initialize_subspace.hpp:27). The random fill uses
    np.random.default_rng(42), as the JAX package does, so both start from
    the same block."""
    nk = ctx.gkvec.num_kpoints
    nb = ctx.num_bands
    ngk = ctx.gkvec.ngk_max
    ao = atomic_orbitals(ctx.unit_cell, ctx.gkvec, ctx.cfg.parameters.gk_cutoff + 1e-9)
    nao = ao.shape[1]
    nbig = max(nb, nao)
    rng = np.random.default_rng(42)
    psi = np.zeros((nk, ctx.num_spins, nbig, ngk), dtype=np.complex128)
    for ik in range(nk):
        base = np.zeros((nbig, ngk), dtype=np.complex128)
        n0 = min(nao, nbig)
        if n0:
            base[:n0] = ao[ik, :n0]
        if nbig > n0:
            r = rng.standard_normal((nbig - n0, ngk)) + 1j * rng.standard_normal((nbig - n0, ngk))
            # damp high-G components so random vectors are smooth-ish
            damp = 1.0 / (1.0 + ctx.gkvec.kinetic()[ik])
            base[n0:] = r * damp
        base *= ctx.gkvec.mask[ik]
        for ispn in range(ctx.num_spins):
            psi[ik, ispn] = base
    return psi


def _band_gap(evals: np.ndarray, occ: np.ndarray, ctx: SimulationContext) -> float:
    tol = 1e-6 * ctx.max_occupancy
    occupied = evals[occ > ctx.max_occupancy - 1e-4]
    empty = evals[occ < tol]
    if len(occupied) == 0 or len(empty) == 0:
        return 0.0
    gap = float(empty.min() - occupied.max())
    # metallic if partial occupancies straddle
    partial = (occ > tol) & (occ < ctx.max_occupancy - 1e-4)
    if np.any(partial) and gap < 1e-8:
        return 0.0
    return max(gap, 0.0)


def default_autosave_path(cfg: Config, base_dir: str) -> str:
    """The autosave file: control.autosave_path if set, else
    <base_dir>/sirius_autosave.h5, or sirius_autosave.<tag>.h5 under
    control.autosave_tag (sirius_tpu/dft/scf.py:134-140), so jobs that
    share a directory keep their own files."""
    if cfg.control.autosave_path:
        return cfg.control.autosave_path
    tag = str(cfg.control.autosave_tag or "")
    name = f"sirius_autosave.{tag}.h5" if tag else "sirius_autosave.h5"
    return os.path.join(base_dir, name)


def run_scf(cfg: Config, ctx: SimulationContext | None = None,
            device=None, base_dir: str = ".", restart_from: str | None = None,
            save_to: str | None = None, resume: str | None = None) -> dict:
    """Ground-state SCF. device=None runs on the GPU (and raises without
    CUDA); device="cpu" runs the plain PyTorch versions of the kernels. A
    non-collinear context (num_mag_dims 3) runs dft/scf_nc.py::run_scf_nc.
    Without ctx the context is built from cfg, its species files resolved
    against base_dir (the deck's directory in run_scf_from_file), which is
    also where the autosave goes by default.

    Where fuses(cfg, ctx) holds, the part of each iteration after the band
    solve is dft/fused.py's step (K13, the density, K4, K6, the device
    mixer K14a/K14b, the potential, K5, the ledger, K15) and the loop
    reads one scalar record an iteration; control.device_scf = "off" keeps
    the host loop.

    Checkpoints (io/checkpoint.py, the JAX package's sirius.h5 schema):
    restart_from warm-starts a new run from a file's density (and
    magnetization); resume continues the run a control.autosave_every
    autosave left (the mixed vector, the mixer history, beta and kind, the
    band-solve tolerance, the histories, the iteration count, the
    wave-function precision and the bands as the warm start): bit for bit
    on the host loop. save_to writes the final state with the bands, band
    energies and occupations.

    Supervision (dft/recovery.py, control.scf_supervision, on by default):
    a non-finite record, density, band energies or potential, an energy
    blow-up or a diverging residual roll the loop back to the last
    snapshot (every iteration on the host loop; every
    control.snapshot_every and while the forecaster warns on the fused
    step, through FusedScf.fetch_state) and escalate the ladder: flush the
    mixer history, halve beta and mix linearly, leave the fused step,
    abort (ScfAbortError, a FloatingPointError). An injected device
    out-of-memory error takes the OOM ladder. With supervision off the
    first such event raises.

    Returns the JAX package's result dict for the keys of this slice
    (energies under the reference's names; mag_history and, polarized,
    magnetisation; recovery, the supervisor's ladder history; timers, the
    profiler's spans; forecast), plus the wall time of each iteration and
    of each band solve and the precision each band solve ran at
    (wf_precision, "fp32" or "fp64"), device_scf (whether the fused step
    ran at the end) and scf_scalars (its per-iteration records,
    dft/fused.py's slots; empty on the host loop). Under
    control.print_forces / print_stress it adds "forces" [natom, 3] and
    "stress" [3, 3] (dft/forces.py, dft/stress.py) with forces_seconds,
    stress_seconds and stress_term_seconds; a non-collinear run returns
    neither, as the JAX package's run_scf_nc does."""
    device = resolve_device(device)
    t0 = time.time()
    reset_timers()
    if os.environ.get("SIRIUS_TPU_FAULTS"):
        # a child process inherits its fault plan through the environment;
        # an in-process plan (faults.install) is left as it is
        faults.load_env()
    check_supported(cfg)
    p = cfg.parameters
    if ctx is None:
        ctx = SimulationContext.create(cfg, base_dir)
    check_context(cfg, ctx)
    xc = XCFunctional(p.xc_functionals)
    mgga = xc.is_mgga
    if mgga and ctx.aug is not None:
        warnings.warn(
            "mGGA with ultrasoft augmentation: tau is computed from the "
            "smooth wave functions only (no augmentation tau), matching "
            "the common PW-code approximation")
    nk, ns, nb = ctx.gkvec.num_kpoints, ctx.num_spins, ctx.num_bands
    polarized = ctx.num_mag_dims == 1
    nel = ctx.unit_cell.num_valence_electrons - p.extra_charge
    if nb * ctx.max_occupancy * ctx.num_spins < nel - 1e-12:
        raise ValueError(
            f"num_bands={nb} cannot hold {nel} electrons "
            f"(max {nb * ctx.max_occupancy * ctx.num_spins})"
        )
    if ctx.num_mag_dims == 3:
        # the JAX package's answers (scf.py:244-259); it ignores resume
        # and the autosave there too (ROADMAP queue 3 item 18), which the
        # port says
        if restart_from:
            raise NotImplementedError(
                "non-collinear SCF does not support checkpoint/warm-start "
                "state passing yet")
        if save_to:
            warnings.warn("non-collinear SCF does not write checkpoints yet; "
                          "save_to ignored")
        if resume or cfg.control.autosave_every:
            warnings.warn("non-collinear SCF does not resume or autosave "
                          "yet; resume and control.autosave_every ignored")
        return run_scf_nc(cfg, ctx, device)
    itsol = cfg.iterative_solver
    omega = ctx.unit_cell.omega
    tables = grid_tables(ctx, device)
    kweights = torch.as_tensor(ctx.kweights, dtype=torch.float64, device=device)

    ng = ctx.gvec.num_gvec
    rho_g = torch.as_tensor(initial_density_g(ctx), dtype=torch.complex128,
                            device=device)
    mag_g = (torch.as_tensor(initial_magnetization_g(ctx),
                             dtype=torch.complex128, device=device)
             if polarized else None)

    def on_device(a):
        """A complex128 tensor on the run's device from a host array (a
        checkpoint's) or a tensor (a snapshot's)."""
        return torch.as_tensor(a, dtype=torch.complex128, device=device)

    if restart_from:
        # density-only warm start of a new run (scf.py:319-327)
        state = load_state(restart_from, ctx)
        rho_g = on_device(state["rho_g"])
        if polarized and state.get("mag_g") is not None:
            mag_g = on_device(state["mag_g"])
    resume_scf = resume_psi = None
    if resume:
        state = load_state(resume, ctx)
        rho_g = on_device(state["rho_g"])
        if polarized and state.get("mag_g") is not None:
            mag_g = on_device(state["mag_g"])
        resume_scf = state.get("scf")
        resume_psi = state.get("psi")
    # mGGA: tau = 0 before the first band solve (SCAN's alpha = 0 region);
    # the Cartesian G+k vectors of the tau operator, uploaded once
    tau_g = gkc = None
    if mgga:
        tau_g = torch.zeros((ns, ng), dtype=torch.complex128, device=device)
        gkc = torch.as_tensor(np.asarray(ctx.gkvec.gkcart, dtype=np.float64),
                              device=device)
    pot = generate_potential(ctx, rho_g, xc, tables, mag_g, tau_g)
    psi = None
    psi_big = _initial_subspace(ctx)
    if resume_psi is not None and resume_psi.shape == (
            nk, ns, nb, ctx.gkvec.ngk_max):
        # the autosaved bands warm-start the resumed band solve, which the
        # bit-for-bit continuation needs (scf.py:377-382)
        psi = on_device(np.asarray(resume_psi)
                        * ctx.gkvec.mask[:, None, None, :])
        psi_big = None
    # the mixed vector: [rho; m] polarized (scf.py:507-530)
    mixer = Mixer(cfg.mixer, ctx.gvec.glen2, omega=omega, device=device,
                  num_components=2 if polarized else 1)
    x_mix = torch.cat([rho_g, mag_g]) if polarized else rho_g
    path = band_solve_path(cfg, ctx)
    chunk = cfg.control.beta_chunk_size
    # the band solve's working type: complex64 on the fp32 path until the
    # polish switch (scf.py:266); the fp64 tables below are refreshed from
    # the potential and cast to it (astype) at every band solve
    wf_dtype = torch.complex64 if p.precision_wf == "fp32" else torch.complex128
    prm = gm = gp = x_packed = None
    # the dense projector table's footprint and whether the deck may take
    # the chunked projectors, which the OOM ladder engages mid-run
    # (scf.py:676-690)
    bc_foot = ctx.beta.num_beta_total * ctx.gkvec.ngk_max * 16
    bchunk_ok = (cfg.control.beta_chunked not in (False, "false", "off")
                 and nk == 1 and ns == 1 and not mgga
                 and ctx.beta.num_beta_total > 0)

    def chunked_params():
        """The chunked solve's tables at the current chunk size. H psi
        generates the projectors chunk by chunk (K9). The dense table is
        on the device all the same, as the JAX package's beta_dev is: it
        gives the preconditioner diagonals (the JAX _h_o_diag) and the
        ultrasoft density matrix. density_kset reads prm's veff_r,
        fft_index and mask as it reads HkSetParams'."""
        c = make_chunked_hk(ctx, 0, chunk=chunk, device=device)
        c.o_diag = torch.as_tensor(compute_o_diag(ctx), device=device)
        dense = torch.as_tensor(
            ctx.beta.beta_gk * ctx.gkvec.mask[:, None, :], device=device)
        return c, dense

    if path == "chunked":
        prm, beta_dense = chunked_params()
        ps = prm
    else:
        # constant tables uploaded once; veff_r, D and h_diag follow the
        # potential (norm-conserving: D is the bare D_ion)
        ps = make_hkset_params(ctx, pot.veff_r_coarse.cpu().numpy(),
                               v0=pot.veff_g[0].real, device=device)
        beta_dense = ps.beta
        if path == "gamma":
            gm = build_gamma_map(np.asarray(ctx.gkvec.millers[0]),
                                 np.asarray(ctx.gkvec.mask[0]))
            # one GammaParams for both spins: refresh and gamma_spin swap
            # veff_r and D
            gp = make_gamma_params(ctx, pot.veff_r_coarse[0].cpu().numpy(),
                                   gm, device=device)
    aug_tables = dm_sym = None
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=device)
    # D per spin; the bare D_ion of norm-conserving species, which the k-set
    # and Gamma tables were built with
    d_spin = dion.expand(ns, -1, -1)
    if ctx.aug is not None:
        aug_tables = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug,
                                             ctx.beta, device)
        if tables.sym is not None:
            dm_sym = build_dm_sym_tables(ctx, device)

    def refresh(pot):
        """The potential's leaves of the band solve: veff_r, the screened D
        from the current potential (K5 on V + B_z and V - B_z polarized, both
        spins in one launch (scf.py:1236-1243); the bare D of
        norm-conserving species) and h_diag, which reads both."""
        nonlocal d_spin
        v0 = pot.veff_g[0].real
        if aug_tables is not None:
            v_spin = (torch.stack([pot.veff_g + pot.bz_g,
                                   pot.veff_g - pot.bz_g])
                      if polarized else pot.veff_g[None])
            d_spin = d_operator_device(v_spin, dion, aug_tables, omega)
        d = d_spin[0]
        d_s = d_spin.to(torch.complex128).contiguous()
        if prm is not None:
            prm.veff_r = pot.veff_r_coarse
            if aug_tables is not None:
                prm.dmat = torch.as_tensor(
                    pack_dmat_chunks(ctx, d.cpu().numpy(), chunk),
                    device=device)
            prm.h_diag = compute_h_diag(prm.ekin, prm.mask, beta_dense, d_s,
                                        v0)[0]
            return
        ps.veff_r = pot.veff_r_coarse
        ps.dion = d_s
        ps.h_diag = compute_h_diag(ps.ekin, ps.mask, ps.beta, ps.dion, v0)

    def gamma_spin(ispn):
        """The one GammaParams with this spin's veff_r and D swapped in
        (scf.py:1400-1403), at the working precision."""
        gp.veff_r = pot.veff_r_coarse[ispn]
        gp.dion = d_spin[ispn].contiguous()
        return astype(gp, real_dtype_of(wf_dtype))

    counters = {"num_loc_op_applied": 0}
    etot_history, rms_history, iter_seconds, band_seconds = [], [], [], []
    mag_history, precision_history = [], []
    e_prev, converged, rms, scf_correction = None, False, 0.0, 0.0
    mu = entropy_sum = None
    evals = occ = None
    # what forces and stress read of the last iteration: the D of its band
    # solve, its symmetrized density matrix, and rho_out - rho_in
    d_solve = dm = rho_resid = None
    num_iter_done = it0 = 0
    res_tol = itsol.residual_tolerance
    if resume_scf is not None:
        # --- mid-SCF resume (scf.py:793-840): the mixed vector, the mixer
        # history and its beta / kind, the band-solve tolerance, the
        # histories and the iteration count; the potential is rebuilt from
        # the mixed vector. With the bands restored above, the host loop
        # replays the uninterrupted run's trajectory ---
        if mgga:
            raise NotImplementedError(
                "mid-SCF resume with mGGA (tau is not checkpointed)")
        x_mix = on_device(resume_scf["x_mix"])
        rho_g = x_mix[:ng]
        mag_g = x_mix[ng:2 * ng] if polarized else None
        with profile("scf::potential"):
            pot = generate_potential(ctx, rho_g, xc, tables, mag_g)
        mixer.import_history(resume_scf)
        mixer.beta = float(resume_scf.get("mix_beta", mixer.beta))
        mixer.kind = str(resume_scf.get("mix_kind", mixer.kind))
        res_tol = float(resume_scf.get("res_tol", res_tol))
        if "e_prev" in resume_scf:
            e_prev = float(resume_scf["e_prev"])
        etot_history = [float(v) for v in resume_scf.get("etot_history", [])]
        rms_history = [float(v) for v in resume_scf.get("rms_history", [])]
        mag_history = [float(v) for v in resume_scf.get("mag_history", [])]
        if "evals" in resume_scf:
            evals = torch.as_tensor(np.asarray(resume_scf["evals"],
                                               dtype=np.float64),
                                    device=device)
        it0 = num_iter_done = int(resume_scf.get("iteration", 0))
        # an fp32 -> fp64 polish switch that fired before the save holds
        wf_dtype = (torch.complex128
                    if bool(resume_scf.get("wf_fp64",
                                           p.precision_wf == "fp64"))
                    else torch.complex64)
    if path == "chunked" or aug_tables is not None or resume_scf is not None:
        # the k-set and Gamma tables of a norm-conserving deck were built
        # from the initial potential already
        refresh(pot)
    # the JAX package's fused step (fuses: the k-set solve only); whether
    # it ran to the end also decides the D that forces and stress read
    fused = out = None

    def new_fused():
        """The fused step with the mixer's beta and kind as they are now
        (a rollback that changes them rebuilds it, scf.py:885-898)."""
        return FusedScf(ctx, xc, mixer, polarized, tables, aug_tables, dm_sym,
                        ps.beta, ps.ekin, ps.mask)

    if fuses(cfg, ctx):
        fused = new_fused()
        fused.init_carry(x_mix, pot, history=(mixer.export_history() or None)
                         if resume_scf is not None else None)
    scf_scalars = []

    # --- supervision (dft/recovery.py, scf.py:918-1034) ---
    sup = ScfSupervisor(cfg.control, mixer.beta, mixer.kind,
                        deck_label=f"nk={nk} ns={ns} nb={nb} ng={ng}",
                        density_tol=float(p.density_tol))
    snap_every = max(1, int(cfg.control.snapshot_every))
    autosave_every = int(cfg.control.autosave_every or 0)
    fc_warnings = 0
    if sup.enabled:
        # the rollback target before any iteration ran: the initial guess
        sup.snapshot(-1, {"x_mix": x_mix.clone(), "res_tol": res_tol})

    def recover(sentinel, detail=""):
        """Roll back to the supervisor's snapshot and apply one ladder
        rung (scf.py:933-1034). Raises ScfAbortError when the ladder or
        the recovery budget is spent, and at once without supervision."""
        nonlocal x_mix, rho_g, mag_g, tau_g, pot, psi, psi_big, x_packed
        nonlocal fused, out, e_prev, res_tol, path, prm, ps, beta_dense, chunk
        d = sup.recover(sentinel, it, detail=detail, state={
            "mixer_beta": mixer.beta, "mixer_kind": mixer.kind,
            "device_scf": fused is not None,
            "beta_chunked": path == "chunked",
            "beta_chunk_eligible": bchunk_ok,
            "beta_chunk_can_halve": int(cfg.control.beta_chunk_size) > 16,
        })
        snap = sup.snap
        x_mix = on_device(snap["x_mix"]).clone()
        if d.flush_history:
            mixer.flush_history()
        if d.beta is not None:
            mixer.beta = d.beta
        if d.kind is not None:
            mixer.kind = d.kind
        res_tol = float(snap.get("res_tol", itsol.residual_tolerance))
        e_prev = None
        rho_g = x_mix[:ng]
        mag_g = x_mix[ng:] if polarized else None
        if mgga:
            # tau of the diverged bands is poisoned too: restart from the
            # tau = 0 start of the first iteration
            tau_g = torch.zeros((ns, ng), dtype=torch.complex128,
                                device=device)
        with profile("scf::potential"):
            pot = generate_potential(ctx, rho_g, xc, tables, mag_g, tau_g)
        # the diverged bands are part of the poisoned trajectory: the band
        # solve starts again from a fresh LCAO subspace
        psi = x_packed = None
        psi_big = _initial_subspace(ctx)
        if d.shrink_beta_budget:
            # OOM rung 0 (repeatable): a quarter of the dense-table budget,
            # below the table's footprint, and half the chunk
            cfg.control.beta_chunk_budget_bytes = min(
                float(cfg.control.beta_chunk_budget_bytes) / 4.0,
                bc_foot / 2.0)
            cfg.control.beta_chunk_size = max(
                16, int(cfg.control.beta_chunk_size) // 2)
        if ((d.shrink_beta_budget or d.force_beta_chunked) and bchunk_ok
                and (d.force_beta_chunked or path == "chunked"
                     or bc_foot > cfg.control.beta_chunk_budget_bytes)):
            # (re)engage the chunked projectors at the new chunk size
            chunk = cfg.control.beta_chunk_size
            path = "chunked"
            prm, beta_dense = chunked_params()
            ps = prm
        refresh(pot)
        out = None
        if fused is not None:
            if d.disable_device or path == "chunked":
                # rung 2: the rest of the run on the host loop, which checks
                # every field an iteration, with the host Mixer (flushed)
                fused = None
            else:
                if d.beta is not None or d.kind is not None:
                    fused = new_fused()
                fused.init_carry(x_mix, pot)

    def autosave(it):
        """The mid-SCF checkpoint (scf.py:1036-1084): everything resume
        needs to continue this run, written atomically."""
        if fused is not None:
            x_now, hist = fused.fetch_state(with_history=True)
        else:
            x_now, hist = x_mix.cpu().numpy(), mixer.export_history()
        ev_h = None if evals is None else evals.cpu().numpy()
        psi_h = None if psi is None else psi.to(torch.complex128).cpu().numpy()
        scf_state = {
            "x_mix": x_now,
            "iteration": it + 1,
            "res_tol": res_tol,
            "e_prev": e_prev,
            "mix_beta": mixer.beta,
            "mix_kind": mixer.kind,
            "wf_fp64": wf_dtype == torch.complex128,
            "evals": ev_h,
            "etot_history": np.asarray(etot_history),
            "rms_history": np.asarray(rms_history),
            "mag_history": np.asarray(mag_history),
        }
        if hist:
            scf_state.update(hist)
        save_state(default_autosave_path(cfg, base_dir), ctx, x_now[:ng],
                   x_now[ng:] if polarized else None, psi=psi_h,
                   band_energies=ev_h, scf_state=scf_state,
                   rotate_keep=int(cfg.control.autosave_keep))
        # fault site: a preemption right after the autosave
        faults.check("scf.autosave_kill", it)

    it = it0
    for it in range(it0, p.num_dft_iter):
        synchronize(device)
        it_t0 = time.perf_counter()
        # injected device faults at the start of the iteration: an
        # out-of-memory error takes the OOM ladder in the run; a lost
        # device escapes to the caller (scf.py:1205-1221)
        try:
            faults.fire("device.oom", it)
        except RuntimeError as e:
            if devfail.classify(e) != "oom":
                raise
            recover("device_oom", detail=str(e))
            continue
        faults.fire("device.lost", it)
        rdt = real_dtype_of(wf_dtype)
        precision_history.append("fp32" if rdt == torch.float32 else "fp64")
        d_solve = d_spin
        band = None if path == "gamma" else astype(ps, wf_dtype)
        with profile("scf::band_solve"):
            if psi_big is not None:
                # first iteration: rotate the full atomic-orbital block down
                # to the lowest nb Ritz vectors (reference
                # initialize_subspace.hpp:279)
                if path == "gamma":
                    # one packed block per spin, each rotated under its own
                    # potential (scf.py:1404-1420)
                    x_packed = []
                    for ispn in range(ns):
                        xb = torch.as_tensor(
                            pack(gm, psi_big[0, ispn:ispn + 1]),
                            device=device).to(rdt)
                        gw = gamma_spin(ispn)
                        hx, sx = apply_h_s_gamma(gw, xb)
                        x_packed.append(subspace_rotate(xb, hx, sx, nb,
                                                        mask=gw.mask_p[None]))
                else:
                    big = torch.as_tensor(psi_big, device=device)
                    if path == "chunked":
                        # applied at the working precision, rotated in fp64
                        # (scf.py:1348-1361)
                        xb = big[0] * prm.mask[:, None, :]
                        hx, sx = apply_h_s_chunked(band, xb.to(wf_dtype))
                        psi = subspace_rotate(xb, hx.to(xb.dtype),
                                              sx.to(xb.dtype), nb)[None]
                    else:
                        psi = initialize_subspace_kset(band, big.to(wf_dtype),
                                                       nb)
                    del big
                counters["num_loc_op_applied"] += nk * ns * psi_big.shape[2]
                psi_big = None
            elif path == "gamma" and x_packed is None:
                # a resumed run: the packed blocks of the saved bands
                # (scf.py:1390-1395)
                psi_np = psi.cpu().numpy()
                x_packed = [torch.as_tensor(pack(gm, psi_np[0, ispn:ispn + 1]),
                                            device=device).to(rdt)
                            for ispn in range(ns)]
            # --- band solve over the whole (k, spin) set ---
            if path == "gamma":
                # packed-real solve per spin (scf.py:1376-1440) with that
                # spin's preconditioner diagonals; the density takes the
                # unpacked bands (fp64 diagonals cast to the working type;
                # the fp64 packed bands unpack to the complex128 bands of
                # the density, as the JAX package's host unpack,
                # scf.py:1439-1440)
                hd_p, od_p = pack_diags(gm, ps.h_diag[0],
                                        ps.o_diag.expand(ns, -1))
                hd_p, od_p = hd_p.to(rdt), od_p.to(rdt)
                evs = []
                for ispn in range(ns):
                    ev_s, x_packed[ispn], _ = davidson_gamma(
                        gamma_spin(ispn), x_packed[ispn].to(rdt),
                        hd_p[ispn:ispn + 1], od_p[ispn:ispn + 1],
                        num_steps=itsol.num_steps, res_tol=res_tol)
                    evs.append(ev_s)
                ev = torch.cat(evs)
                psi = unpack_device(gp, torch.cat(x_packed).double())[None]
            elif path == "chunked":
                # the density takes complex128 bands (scf.py:1375)
                ev, x, rn = davidson(apply_h_s_chunked, band,
                                     psi[0].to(wf_dtype), band.h_diag,
                                     band.o_diag, band.mask,
                                     num_steps=itsol.num_steps,
                                     res_tol=res_tol)
                psi = x[None].to(torch.complex128)
            elif mgga:
                # the tau term in the operator (scf.py:1566-1575)
                ev, psi, rn = davidson_kset_mgga(band,
                                                 pot.vtau_r_coarse.to(rdt),
                                                 gkc.to(rdt), psi.to(wf_dtype),
                                                 num_steps=itsol.num_steps,
                                                 res_tol=res_tol)
            else:
                ev, psi, rn = davidson_kset(band, psi.to(wf_dtype),
                                            num_steps=itsol.num_steps,
                                            res_tol=res_tol)
            counters["num_loc_op_applied"] += nk * ns * num_applies(
                itsol.num_steps, nb)
            if path == "kset" and not mgga and cfg.control.scf_supervision:
                _, rn_ok = residual_health(
                    rn, blowup=cfg.control.band_residual_blowup)
                if faults.armed("scf.band_stagnate", it):
                    rn_ok = False
                if not rn_ok:
                    # one deeper retry, warm-started from the stagnated
                    # block (the JAX package retries on this path only, not
                    # under mGGA, and only under control.scf_supervision:
                    # scf.py:1644)
                    ev, psi, rn = davidson_kset(band, psi,
                                                num_steps=2 * itsol.num_steps,
                                                res_tol=res_tol)
                    counters["num_loc_op_applied"] += nk * ns * num_applies(
                        2 * itsol.num_steps, nb)
            evals = ev.reshape(nk, ns, nb).to(torch.float64)
            synchronize(device)
        band_seconds.append(time.perf_counter() - it_t0)

        if fused is not None:
            # --- the fused step: K13, the density and the density matrix,
            # then dft/fused.py; one record comes back (scf.py:1726-1860) ---
            with profile("scf::fused_step"):
                mu, occ, entropy_sum = find_fermi(
                    evals, kweights, nel, p.smearing_width, kind=p.smearing,
                    max_occupancy=ctx.max_occupancy)
                occ_w = occ * kweights[:, None, None]
                acc = density_kset(band, psi, occ_w)
                # fault site: NaN into the accumulated density, on the
                # device
                acc = faults.corrupt("scf.density", it, acc)
                dm = (density_matrix_kset(beta_dense, psi, occ_w)
                      if aug_tables is not None else None)
                out = fused.step(acc, dm, evals, occ_w, entropy_sum, psi)
            rec = read_record(out.record)
            if not (np.all(np.isfinite(rec)) and rec[S_FINITE] == 1.0):
                # non-finite fields on the device: roll back and escalate
                recover("device_nonfinite",
                        detail="non-finite scalars/fields from the fused step")
                continue
            pot, d_spin, dm, rho_resid = out.pot, out.d_spin, out.dm, out.resid
            ps.veff_r = pot.veff_r_coarse
            ps.dion = d_spin.to(torch.complex128).contiguous()
            ps.h_diag = out.h_diag
            scf_scalars.append(rec)
            rms = rec[S_RMS]
            dens_metric = rec[S_EHA] if mixer.use_hartree else rms
            res_tol = schedule_res_tol(itsol, res_tol, dens_metric, nel,
                                       mixer.use_hartree)
            scf_correction = (rec[S_E2] - rec[S_E1] if p.use_scf_correction
                              else 0.0)
            e_total = ((rec[S_EVAL] - rec[S_VXC] - rec[S_BXC]
                        - 0.5 * rec[S_VHA] + rec[S_EXC])
                       + ctx.e_ewald + scf_correction)
            etot_history.append(e_total + rec[S_ENT])
            rms_history.append(rms)
            if polarized:
                mag_history.append(rec[S_MAG])
        else:
            # fault site: NaN into the band energies (found with the other
            # non-finite fields below)
            evals = faults.corrupt("scf.evals", it, evals)
            checksums.checksum("evals", evals)
            # --- occupations and the new density ---
            mu, occ, entropy_sum = find_fermi(
                evals, kweights, nel, p.smearing_width, kind=p.smearing,
                max_occupancy=ctx.max_occupancy)
            occ_w = occ * kweights[:, None, None]
            # the k-set bands are at the working precision, with `band`'s
            # tables; the Gamma and chunked paths hand the density complex128
            # bands, with the fp64 tables
            dens = band if path == "kset" else ps
            with profile("scf::density"):
                rho_spin = density_from_coarse_acc(
                    ctx, density_kset(dens, psi, occ_w), tables)
                if mgga:
                    # tau of the current bands, symmetrized as a scalar field
                    # per spin; not mixed: the potential takes the mixed rho
                    # with this fresh tau (scf.py:1949-1969)
                    tau_g = density_from_coarse_acc(
                        ctx, tau_kset(dens, gkc.to(rdt), psi, occ_w), tables)
                    if tables.sym is not None:
                        tau_g = symmetrize_tau(tables.sym, tau_g)
                if aug_tables is not None:
                    # beta density matrix -> its space-group average ->
                    # rho_aug (K4)
                    dm = density_matrix_kset(beta_dense, psi, occ_w)
                    if dm_sym is not None:
                        dm = symmetrize_density_matrix_device(dm, dm_sym)
                    rho_spin += rho_aug_g_device(dm.contiguous(), aug_tables,
                                                 ctx.gvec.num_gvec)
                rho_new = rho_spin.sum(dim=0)
                mag_new = rho_spin[0] - rho_spin[1] if polarized else None
                checksums.checksum("rho_new", rho_new)
                if tables.sym is not None:
                    rho_new = symmetrize_pw(tables.sym, rho_new)
                    if polarized:
                        mag_new = symmetrize_pw(tables.sym, mag_new,
                                                axial_z=True)
                # fault site: NaN into the new density
                rho_new = faults.corrupt("scf.density", it, rho_new)
                x_new = torch.cat([rho_new, mag_new]) if polarized else rho_new
            if not (bool(torch.all(torch.isfinite(evals))) and bool(
                    torch.all(torch.isfinite(torch.view_as_real(x_new))))):
                bad = [name for name, a in (("evals", evals),
                                            ("rho_new", rho_new),
                                            ("mag_new", mag_new))
                       if a is not None and not bool(torch.all(torch.isfinite(
                           torch.view_as_real(a) if a.is_complex() else a)))]
                recover("nonfinite_fields", detail=f"non-finite {bad}")
                continue

            # --- mixing ---
            rho_resid = rho_new - x_mix[:ng]
            rms = mixer.rms(x_mix, x_new)
            x_mix = mixer.mix(x_mix, x_new)
            eha_res = mixer.residual_hartree_energy(x_mix, x_new)
            dens_metric = eha_res if mixer.use_hartree else rms
            res_tol = schedule_res_tol(itsol, res_tol, dens_metric, nel,
                                       mixer.use_hartree)
            rho_g = x_mix[:ng]
            mag_g = x_mix[ng:] if polarized else None

            # first-order (Harris-like) correction: E_pot[rho_out, m_out] under
            # the new vs old potential (reference dft_ground_state.cpp:245,
            # 320-322; scf.py:2082-2088)
            def _epot(p_):
                e = float(torch.vdot(rho_new, p_.veff_g).real) * omega
                if polarized:
                    e += float(torch.vdot(mag_new, p_.bz_g).real) * omega
                return e

            e1 = _epot(pot)
            with profile("scf::potential"):
                pot = generate_potential(ctx, rho_g, xc, tables, mag_g, tau_g)
            # fault site: NaN into the effective potential
            pot.veff_r_coarse = faults.corrupt("scf.potential", it,
                                               pot.veff_r_coarse)
            if not bool(torch.all(torch.isfinite(pot.veff_r_coarse))):
                recover("potential_nonfinite",
                        detail="non-finite effective potential from a finite "
                        "density")
                continue
            checksums.checksum("veff", pot.veff_g)
            refresh(pot)
            scf_correction = _epot(pot) - e1 if p.use_scf_correction else 0.0
            eval_sum = float(torch.sum(kweights[:, None, None] * occ * evals))
            e = energies_host(pot)
            e_total = (eval_sum - e["vxc"] - e["bxc"] - e["vtau_tau"]
                       - 0.5 * e["vha"] + e["exc"] + ctx.e_ewald + scf_correction)
            etot_history.append(e_total + float(entropy_sum))
            rms_history.append(rms)
            if polarized:
                # the total moment of the output density, before mixing
                mag_history.append(float(mag_new[0].real) * omega)
        num_iter_done = it + 1
        iter_seconds.append(time.perf_counter() - it_t0)
        sentinel = sup.observe(it, rms, e_total)
        if sentinel is not None:
            recover(sentinel)
            continue
        if sup.enabled and sup.forecast_enabled:
            # fault site: a wrong forecast, maximum warning with no real
            # divergence (scf.py:1102-1106)
            if faults.armed("scf.forecast_misfire", it):
                sup.inject_warning(1.0)
            fc = sup.forecast_snapshot()
            if fc and float(fc.get("warning") or 0.0) >= \
                    sup.forecast_warning_threshold:
                fc_warnings += 1
        if sup.enabled:
            if fused is None:
                # host loop: the mixed vector is on the device, so the
                # snapshot is a device copy, every iteration
                sup.snapshot(it, {"x_mix": x_mix.clone(), "e_total": e_total,
                                  "res_tol": res_tol})
            elif it % snap_every == 0 or sup.should_snapshot():
                # fused step: a host copy of the carry's mixed vector every
                # snapshot_every iterations and while the forecaster warns
                # (scf.py:1845-1857)
                x_snap, _ = fused.fetch_state()
                sup.snapshot(it, {"x_mix": x_snap, "e_total": e_total,
                                  "res_tol": res_tol})
        de = abs(e_total - e_prev) if e_prev is not None else np.inf
        e_prev = e_total
        if (wf_dtype == torch.complex64 and cfg.settings.fp32_to_fp64_rms > 0
                and rms < cfg.settings.fp32_to_fp64_rms):
            # the fp32 -> fp64 polish: the next band solve runs on complex128
            # tables and bands, and this iteration may not end the run
            # (scf.py:2200-2212)
            wf_dtype = torch.complex128
            continue
        # the autosave after the e_prev and precision bookkeeping: the saved
        # state is what the next iteration of an uninterrupted run starts
        # from (scf.py:2212-2216)
        if autosave_every and (it + 1) % autosave_every == 0:
            autosave(it)
        if de < p.energy_tol and dens_metric < p.density_tol:
            converged = True
            break

    # --- final report ---
    if fused is not None and out is not None:
        # the mixed density of the carry: pot is its potential already
        fin = fused.finalize(out)
        rho_g, mag_g = fin["rho_g"], fin["mag_g"]
    evals_np = (np.zeros((nk, ns, nb)) if evals is None
                else evals.cpu().numpy())
    occ_np = np.zeros((nk, ns, nb)) if occ is None else occ.cpu().numpy()
    e = energies_host(pot)
    eval_sum = float(np.sum(ctx.kweights[:, None, None] * occ_np * evals_np))
    ent = 0.0 if entropy_sum is None else float(entropy_sum)
    e_total = (eval_sum - e["vxc"] - e["bxc"] - e["vtau_tau"]
               - 0.5 * e["vha"] + e["exc"] + ctx.e_ewald + scf_correction)
    rho_r = rho_real_space(tables, rho_g)
    fc = sup.forecast_snapshot() or {}
    result = {
        "converged": converged,
        "num_scf_iterations": num_iter_done,
        "efermi": 0.0 if mu is None else float(mu),
        "band_gap": _band_gap(evals_np, occ_np, ctx),
        "rho_min": float(rho_r.min()),
        "etot_history": etot_history,
        "rms_history": rms_history,
        "mag_history": mag_history,
        # the supervisor's record: an empty ladder_history means the run
        # never rolled back
        "recovery": {
            "recoveries": sup.recoveries,
            "rung": sup.rung,
            "ladder_history": list(sup.history),
        },
        "scf_time": time.time() - t0,
        "iteration_seconds": iter_seconds,
        "band_solve_seconds": band_seconds,
        "wf_precision": precision_history,
        "device": str(device),
        "device_scf": fused is not None,
        "scf_scalars": scf_scalars,
        "energy": {
            "total": e_total,
            "free": e_total + ent,
            "eval_sum": eval_sum,
            "kin": eval_sum - e["veff"] - e["bxc"] - e["vtau_tau"],
            "veff": e["veff"],
            "vha": e["vha"],
            "vxc": e["vxc"],
            "vloc": e["vloc"],
            "exc": e["exc"],
            "bxc": e["bxc"],
            "ewald": ctx.e_ewald,
            "entropy_sum": ent,
            "scf_correction": scf_correction,
            "hubbard": 0.0,
            "hubbard_one_el": 0.0,
            "paw_total_energy": 0.0,
            "paw_one_elec": 0.0,
        },
        "band_energies": evals_np.tolist(),
        "band_occupancies": occ_np.tolist(),
        "counters": counters,
        "timers": timer_report(),
        # the convergence forecast (obs/forecast.py via the supervisor)
        "forecast": {
            "enabled": bool(sup.enabled and sup.forecast_enabled),
            "decay_rate": fc.get("decay_rate"),
            "forecast_total": fc.get("forecast_total"),
            "forecast_remaining": fc.get("forecast_remaining"),
            "warning": fc.get("warning"),
            "warnings_total": fc_warnings,
            "actual_iterations": num_iter_done,
        },
        "_state": {"rho_g": rho_g, "mag_g": mag_g, "psi": psi},
    }
    if polarized:
        mag_np = mag_g.cpu().numpy()
        result["magnetisation"] = {
            "total": [0.0, 0.0, float(mag_np[0].real) * omega],
            "atoms": [[0.0, 0.0, float(mz)]
                      for mz in atomic_moments(ctx, mag_np)],
        }
    c = cfg.control
    if (c.print_forces or c.print_stress) and num_iter_done > 0:
        d_last = d_spin if fused is not None else d_solve
        result.update(_forces_and_stress(
            ctx, xc, device, tables, aug_tables, beta_dense, rho_g, mag_g,
            pot, psi, occ_np, evals_np, d_last, dm, rho_resid))
    if save_to and psi is not None:
        # the final state with the bands (scf.py:2409-2416); no band solve
        # ran when psi is None, and then nothing is written, as there
        save_state(save_to, ctx, rho_g.cpu().numpy(),
                   None if mag_g is None else mag_g.cpu().numpy(),
                   pot.veff_g.cpu().numpy(),
                   None if pot.bz_g is None else pot.bz_g.cpu().numpy(),
                   psi.to(torch.complex128).cpu().numpy(), evals_np, occ_np)
    return result


def _forces_and_stress(ctx, xc, device, tables, aug_tables, beta_dense,
                       rho_g, mag_g, pot, psi, occ, evals, d_spin, dm,
                       rho_resid) -> dict:
    """result["forces"] [natom, 3] under control.print_forces and
    result["stress"] [3, 3] under control.print_stress, as lists, with the
    seconds of each (ending in a synchronize) and of each stress term
    (sirius_tpu/dft/scf.py:2358-2408). The fields go to the host once; the
    bands stay on the device for the non-local force, widened to
    complex128 as the JAX package's join_cplx widens the fp32 bands."""
    from sirius_tpu_torch.dft.forces import total_forces
    from sirius_tpu_torch.dft.stress import StressCalculator

    c = ctx.cfg.control

    def host(t):
        return None if t is None else t.cpu().numpy()

    psi = psi.to(torch.complex128)
    d_by_spin = list(host(d_spin))
    dm_blocks = []
    if dm is not None:
        dm_np = host(dm)
        dm_blocks = [[dm_np[s, off:off + nbf, off:off + nbf]
                      for _, off, nbf in ctx.beta.atom_blocks(ctx.unit_cell)]
                     for s in range(dm_np.shape[0])]
    rho_np, mag_np = host(rho_g), host(mag_g)
    out = {}
    if c.print_forces:
        synchronize(device)
        t0 = time.perf_counter()
        fterms = total_forces(
            ctx, rho_np, host(pot.vxc_g), host(pot.veff_g), host(pot.bz_g),
            psi, occ, evals, d_by_spin, dm_blocks,
            rho_resid_g=host(rho_resid), beta=beta_dense)
        synchronize(device)
        out["forces"] = fterms["total"].tolist()
        out["forces_seconds"] = time.perf_counter() - t0
    if c.print_stress:
        synchronize(device)
        t0 = time.perf_counter()
        calc = StressCalculator(ctx, xc, device=device, tables=tables,
                                aug_tables=aug_tables)
        sterms = calc.compute(
            rho_np, mag_np, psi, occ, evals, d_by_spin,
            dm_blocks_by_spin=dm_blocks if ctx.aug is not None else None)
        synchronize(device)
        out["stress"] = sterms["total"].tolist()
        out["stress_seconds"] = time.perf_counter() - t0
        out["stress_term_seconds"] = dict(calc.seconds)
    return out


# the tasks of sirius_tpu/cli.py that the port does not run yet, and the
# ROADMAP queue 1 item that brings each
UNPORTED_TASKS = {
    "ground_state_relax": 9,
    "ground_state_direct": 9,
    "k_point_path": 9,
    "molecular_dynamics": 9,
    "eos": 12,
}
# |dE_total|, |dF|_max and |dsigma|_max of test_against (scf.py:2560-2582)
TEST_AGAINST_TOL = 1e-5


def run_scf_from_file(path: str, test_against: str | None = None,
                      task: str = "ground_state_new", device=None) -> int:
    """The sirius.scf mini-app on a deck file, as
    sirius_tpu/dft/scf.py::run_scf_from_file runs ground_state_new and
    ground_state_restart: species files resolved against the deck's
    directory, the final state written to sirius.h5 there, the result
    written to output.json in the working directory (ground_state, task,
    config, git_hash, comm_world_size; ground_state is run_scf's result
    without its tensors), a summary printed. ground_state_restart resumes
    the newest valid autosave (control.autosave_path or the default
    sirius_autosave[.tag].h5 beside the deck, and its rotated
    generations), or else warm-starts from sirius.h5's density. With
    test_against, a reference output.json: its forces or stress switch
    print_forces / print_stress on, and |dE_total|, |dF|_max and
    |dsigma|_max must stay below 1e-5; prints TEST PASSED or TEST FAILED
    (with a one-line summary on stderr) and returns 0 or 1. The other
    tasks raise NotImplementedError naming their ROADMAP queue 1 item.
    device as run_scf's: the GPU unless the caller asks for the CPU."""
    if task in UNPORTED_TASKS:
        raise NotImplementedError(
            f"task '{task}' comes with ROADMAP queue 1, item "
            f"{UNPORTED_TASKS[task]}; the port runs ground_state_new and "
            "ground_state_restart")
    if task not in ("ground_state_new", "ground_state_restart"):
        raise ValueError(f"unknown task '{task}'")
    cfg = load_config(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    state_file = os.path.join(base_dir, "sirius.h5")
    ref = None
    if test_against:
        with open(test_against) as f:
            ref = json.load(f)["ground_state"]
        # a reference quantity left uncomputed would fail the comparison:
        # switch the calculations on
        if "forces" in ref:
            cfg.control.print_forces = True
        if "stress" in ref:
            cfg.control.print_stress = True
    if task == "ground_state_restart":
        # the newest valid autosave continues the interrupted run with its
        # mixer, bands and tolerance; else sirius.h5's density starts a new
        # one (scf.py:2485-2500)
        resume_path = find_resumable(default_autosave_path(cfg, base_dir),
                                     keep=int(cfg.control.autosave_keep))
        if resume_path is not None:
            result = run_scf(cfg, device=device, base_dir=base_dir,
                             resume=resume_path, save_to=state_file)
        else:
            result = run_scf(cfg, device=device, base_dir=base_dir,
                             restart_from=state_file, save_to=state_file)
    else:
        result = run_scf(cfg, device=device, base_dir=base_dir,
                         save_to=state_file)
    result.pop("_state", None)
    out = {
        "ground_state": result,
        "task": task,
        "config": cfg.to_dict(),
        "git_hash": "",
        "comm_world_size": 1,
    }
    summary = {"energy": result["energy"], "efermi": result["efermi"],
               "converged": result["converged"],
               "num_scf_iterations": result["num_scf_iterations"]}
    if "magnetisation" in result:
        summary["magnetisation"] = result["magnetisation"]
    print(json.dumps(summary, indent=2))
    with open("output.json", "w") as f:
        json.dump(out, f, indent=2)
    if ref is None:
        return 0
    fails = []
    de = abs(ref["energy"]["total"] - result["energy"]["total"])
    print(f"|dE_total| vs reference: {de:.3e}")
    if de >= TEST_AGAINST_TOL:
        fails.append(f"|dE_total|={de:.3e} (tol {TEST_AGAINST_TOL:g})")
    for key, label in (("forces", "|dF|_max"), ("stress", "|dsigma|_max")):
        if key not in ref:
            continue
        if key not in result:
            print(f"{key}: present in reference but not computed -> FAIL")
            fails.append(f"{key} missing from result")
            continue
        d = float(np.abs(np.asarray(ref[key])
                         - np.asarray(result[key])).max())
        print(f"{label} vs reference: {d:.3e}")
        if d >= TEST_AGAINST_TOL:
            fails.append(f"{label}={d:.3e} (tol {TEST_AGAINST_TOL:g})")
    print("TEST FAILED" if fails else "TEST PASSED")
    if fails:
        # one machine-greppable line on stderr, as the JAX package prints
        print("sirius-scf-torch: test_against FAILED: " + "; ".join(fails),
              file=sys.stderr)
        return 1
    return 0
