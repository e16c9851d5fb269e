"""SCF ground-state driver (reference: src/dft/dft_ground_state.cpp find
:178-427 and the sirius.scf mini-app output JSON).

Mirrors the host path of sirius_tpu/dft/scf.py::_run_scf_inner for the
configurations of the port: unpolarized, norm-conserving or ultrasoft
plane-wave pseudopotentials on a k-mesh, with or without the space group
(irreducible k-mesh, symmetrized density and potential), LDA (X + PZ),
linear or Anderson mixing. Orchestration is host Python; the
band solve, density, mixing and potential run on tensors on ``device``,
which is the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.dft.density import (
    build_dm_sym_tables,
    density_from_coarse_acc,
    grid_tables,
    initial_density_g,
    rho_real_space,
    symmetrize_density_matrix_device,
    symmetrize_pw,
)
from sirius_tpu_torch.dft.mixer import Mixer, schedule_res_tol
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.dft.potential import generate_potential
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.ops.atomic import atomic_orbitals
from sirius_tpu_torch.ops.augmentation import (
    build_aug_device_tables,
    d_operator_device,
    rho_aug_g_device,
)
from sirius_tpu_torch.parallel.batched import (
    compute_h_diag,
    davidson_kset,
    density_kset,
    density_matrix_kset,
    initialize_subspace_kset,
    make_hkset_params,
)
from sirius_tpu_torch.solvers.davidson import num_applies, residual_health


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration this port slice does
    not cover, naming the ROADMAP item that brings it. Nothing outside the
    slice is computed differently in its place."""
    p = cfg.parameters
    if p.electronic_structure_method != "pseudopotential":
        raise NotImplementedError(
            f"{p.electronic_structure_method}: FP-LAPW comes with ROADMAP "
            "queue 1, slice 13")
    if p.precision_wf == "fp32":
        raise NotImplementedError(
            "precision_wf='fp32' comes with the fp32 precision path "
            "(ROADMAP queue 1, after K9); this slice runs fp64")
    if p.precision_wf != "fp64":
        raise ValueError(f"precision_wf must be fp32 or fp64, got '{p.precision_wf}'")
    if p.num_mag_dims > 0:
        raise NotImplementedError(
            "magnetism (num_mag_dims > 0) comes with ROADMAP queue 1, slice 6 "
            "(polarized) and slice 10 (non-collinear)")
    if p.hubbard_correction or cfg.hubbard.local or cfg.hubbard.nonlocal_:
        raise NotImplementedError("Hubbard corrections: ROADMAP queue 1, slice 10")
    if p.so_correction:
        raise NotImplementedError("spin-orbit: ROADMAP queue 1, slice 10")
    XCFunctional(p.xc_functionals)  # raises outside X + PZ
    if cfg.mixer.type not in ("linear", "anderson", "broyden1"):
        raise NotImplementedError(
            f"mixer '{cfg.mixer.type}': ROADMAP queue 1, slice 5")


def check_context(cfg: Config, ctx: SimulationContext) -> None:
    """The context-level half of check_supported: species and k-set."""
    if any(t.pseudo_type == "PAW" or t.paw for t in ctx.unit_cell.atom_types):
        raise NotImplementedError(
            "PAW species need the on-site PAW terms (ROADMAP queue 1, "
            "slice 4); ultrasoft and norm-conserving species run")
    gamma_only = (ctx.gkvec.num_kpoints == 1 and float(
        np.abs(ctx.gkvec.kpoints[0]).max()) < 1e-12)
    if gamma_only and cfg.control.reduce_gvec:
        raise NotImplementedError(
            "a Gamma-only deck with reduce_gvec=true takes the packed-real "
            "path (kernel K8, ROADMAP queue 1, slice 7); set "
            "control.reduce_gvec=false for the generic k-point path")


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_scf(cfg: Config, ctx: SimulationContext | None = None,
            device=None) -> dict:
    """Ground-state SCF. device=None runs on the GPU (and raises without
    CUDA); device="cpu" runs the plain PyTorch versions of the kernels.

    Returns the JAX package's result dict for the keys of this slice
    (energies under the reference's names), plus the wall time of each
    iteration and of each band solve."""
    device = resolve_device(device)
    t0 = time.time()
    check_supported(cfg)
    p = cfg.parameters
    if ctx is None:
        ctx = SimulationContext.create(cfg)
    check_context(cfg, ctx)
    xc = XCFunctional(p.xc_functionals)
    nk, ns, nb = ctx.gkvec.num_kpoints, ctx.num_spins, ctx.num_bands
    nel = ctx.unit_cell.num_valence_electrons - p.extra_charge
    if nb * ctx.max_occupancy * ctx.num_spins < nel - 1e-12:
        raise ValueError(
            f"num_bands={nb} cannot hold {nel} electrons "
            f"(max {nb * ctx.max_occupancy * ctx.num_spins})"
        )
    itsol = cfg.iterative_solver
    omega = ctx.unit_cell.omega
    tables = grid_tables(ctx, device)
    kweights = torch.as_tensor(ctx.kweights, dtype=torch.float64, device=device)

    rho_g = torch.as_tensor(initial_density_g(ctx), dtype=torch.complex128,
                            device=device)
    pot = generate_potential(ctx, rho_g, xc, tables)
    psi_big = torch.as_tensor(_initial_subspace(ctx), device=device)
    psi = None
    mixer = Mixer(cfg.mixer, ctx.gvec.glen2, omega=omega, device=device)
    x_mix = rho_g
    # constant tables uploaded once; veff_r, D and h_diag follow the
    # potential (norm-conserving: D is the bare D_ion)
    ps = make_hkset_params(ctx, pot.veff_r_coarse.cpu().numpy(),
                           v0=pot.veff_g[0].real, device=device)
    aug_tables = dm_sym = None
    if ctx.aug is not None:
        aug_tables = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug,
                                             ctx.beta, device)
        dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64,
                               device=device)
        if tables.sym is not None:
            dm_sym = build_dm_sym_tables(ctx, device)

    def refresh(pot):
        """The potential's leaves of the band solve: veff_r, the screened D
        from the current potential (K5, one channel per spin) and h_diag,
        which reads both."""
        ps.veff_r = pot.veff_r_coarse
        if aug_tables is not None:
            d = d_operator_device(pot.veff_g, dion, aug_tables, omega)
            ps.dion = d.to(torch.complex128).expand(ns, -1, -1).contiguous()
        ps.h_diag = compute_h_diag(ps.ekin, ps.mask, ps.beta, ps.dion,
                                   pot.veff_g[0].real)

    if aug_tables is not None:
        refresh(pot)

    counters = {"num_loc_op_applied": 0}
    etot_history, rms_history, iter_seconds, band_seconds = [], [], [], []
    e_prev, converged, rms, scf_correction = None, False, 0.0, 0.0
    mu = entropy_sum = None
    evals = occ = None
    num_iter_done = 0
    res_tol = itsol.residual_tolerance
    for it in range(p.num_dft_iter):
        _sync(device)
        it_t0 = time.perf_counter()
        # --- band solve over the whole (k, spin) set ---
        if psi is None:
            # first iteration: rotate the full atomic-orbital block down to
            # the lowest nb Ritz vectors (reference initialize_subspace.hpp:279)
            psi = initialize_subspace_kset(ps, psi_big, nb)
            counters["num_loc_op_applied"] += nk * ns * psi_big.shape[2]
            psi_big = None
        ev, psi, rn = davidson_kset(ps, psi, num_steps=itsol.num_steps,
                                    res_tol=res_tol)
        counters["num_loc_op_applied"] += nk * ns * num_applies(itsol.num_steps, nb)
        _, rn_ok = residual_health(rn, blowup=cfg.control.band_residual_blowup)
        if not rn_ok:
            # one deeper retry, warm-started from the stagnated block
            ev, psi, rn = davidson_kset(ps, psi, num_steps=2 * itsol.num_steps,
                                        res_tol=res_tol)
            counters["num_loc_op_applied"] += nk * ns * num_applies(
                2 * itsol.num_steps, nb)
        evals = ev
        _sync(device)
        band_seconds.append(time.perf_counter() - it_t0)

        # --- occupations and the new density ---
        mu, occ, entropy_sum = find_fermi(
            evals, kweights, nel, p.smearing_width, kind=p.smearing,
            max_occupancy=ctx.max_occupancy)
        occ_w = occ * kweights[:, None, None]
        rho_spin = density_from_coarse_acc(ctx, density_kset(ps, psi, occ_w),
                                           tables)
        if aug_tables is not None:
            # beta density matrix -> its space-group average -> rho_aug (K4)
            dm = density_matrix_kset(ps.beta, psi, occ_w)
            if dm_sym is not None:
                dm = symmetrize_density_matrix_device(dm, dm_sym)
            rho_spin += rho_aug_g_device(dm.contiguous(), aug_tables,
                                         ctx.gvec.num_gvec)
        rho_new = rho_spin.sum(dim=0)
        if tables.sym is not None:
            rho_new = symmetrize_pw(tables.sym, rho_new)
        if not (bool(torch.all(torch.isfinite(evals))) and bool(
                torch.all(torch.isfinite(torch.view_as_real(rho_new))))):
            raise FloatingPointError(
                f"non-finite band energies or density at SCF iteration {it + 1}")

        # --- mixing ---
        rms = mixer.rms(x_mix, rho_new)
        x_mix = mixer.mix(x_mix, rho_new)
        eha_res = mixer.residual_hartree_energy(x_mix, rho_new)
        dens_metric = eha_res if mixer.use_hartree else rms
        res_tol = schedule_res_tol(itsol, res_tol, dens_metric, nel,
                                   mixer.use_hartree)
        rho_g = x_mix

        # first-order (Harris-like) correction: E_pot[rho_out] under the new
        # vs old potential (reference dft_ground_state.cpp:245,320-322)
        def _epot(r_out, p_):
            return float(torch.vdot(r_out, p_.veff_g).real) * omega

        e1 = _epot(rho_new, pot)
        pot = generate_potential(ctx, rho_g, xc, tables)
        if not bool(torch.all(torch.isfinite(pot.veff_r_coarse))):
            raise FloatingPointError(
                f"non-finite effective potential at SCF iteration {it + 1}")
        refresh(pot)
        scf_correction = _epot(rho_new, pot) - e1 if p.use_scf_correction else 0.0
        eval_sum = float(torch.sum(kweights[:, None, None] * occ * evals))
        e = pot.energies
        e_total = (eval_sum - e["vxc"] - e["bxc"] - 0.5 * e["vha"] + e["exc"]
                   + ctx.e_ewald + scf_correction)
        etot_history.append(e_total + float(entropy_sum))
        rms_history.append(rms)
        num_iter_done = it + 1
        iter_seconds.append(time.perf_counter() - it_t0)
        de = abs(e_total - e_prev) if e_prev is not None else np.inf
        e_prev = e_total
        if de < p.energy_tol and dens_metric < p.density_tol:
            converged = True
            break

    # --- final report ---
    evals_np = (np.zeros((nk, ns, nb)) if evals is None
                else evals.cpu().numpy())
    occ_np = np.zeros((nk, ns, nb)) if occ is None else occ.cpu().numpy()
    e = pot.energies
    eval_sum = float(np.sum(ctx.kweights[:, None, None] * occ_np * evals_np))
    ent = 0.0 if entropy_sum is None else float(entropy_sum)
    e_total = (eval_sum - e["vxc"] - e["bxc"] - 0.5 * e["vha"] + e["exc"]
               + ctx.e_ewald + scf_correction)
    rho_r = rho_real_space(tables, rho_g)
    return {
        "converged": converged,
        "num_scf_iterations": num_iter_done,
        "efermi": 0.0 if mu is None else float(mu),
        "band_gap": _band_gap(evals_np, occ_np, ctx),
        "rho_min": float(rho_r.min()),
        "etot_history": etot_history,
        "rms_history": rms_history,
        "scf_time": time.time() - t0,
        "iteration_seconds": iter_seconds,
        "band_solve_seconds": band_seconds,
        "device": str(device),
        "energy": {
            "total": e_total,
            "free": e_total + ent,
            "eval_sum": eval_sum,
            "kin": eval_sum - e["veff"] - e["bxc"],
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
        "_state": {"rho_g": rho_g, "psi": psi},
    }
