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
meta-GGA functionals, linear or Anderson mixing of [rho; m].
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
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from sirius_tpu_torch.config.schema import Config
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
from sirius_tpu_torch.dft.mixer import Mixer, schedule_res_tol
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.dft.potential import generate_potential
from sirius_tpu_torch.dft.scf_nc import run_scf_nc
from sirius_tpu_torch.dft.xc import XCFunctional
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
            "(ROADMAP queue 1, item 2); the port runs fp64")
    if p.precision_wf != "fp64":
        raise ValueError(f"precision_wf must be fp32 or fp64, got '{p.precision_wf}'")
    if p.num_mag_dims not in (0, 1, 3):
        raise ValueError(f"num_mag_dims must be 0, 1 or 3, got {p.num_mag_dims}")
    if p.hubbard_correction or cfg.hubbard.local or cfg.hubbard.nonlocal_:
        raise NotImplementedError("Hubbard corrections: ROADMAP queue 1, item 8")
    if p.so_correction:
        raise NotImplementedError(
            "spin-orbit needs species with j-resolved beta projectors, which "
            "only UPF files carry: ROADMAP queue 1, item 3 (UPF), then item 7")
    XCFunctional(p.xc_functionals)  # raises for an unknown name
    if cfg.mixer.type not in ("linear", "anderson", "broyden1"):
        raise NotImplementedError(
            f"mixer '{cfg.mixer.type}': ROADMAP queue 1, slice 5")


def check_context(cfg: Config, ctx: SimulationContext) -> None:
    """The context-level half of check_supported: species and k-set."""
    if any(t.pseudo_type == "PAW" or t.paw for t in ctx.unit_cell.atom_types):
        raise NotImplementedError(
            "PAW species need the on-site PAW terms (ROADMAP queue 1, "
            "slice 10); ultrasoft and norm-conserving species run")


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


def run_scf(cfg: Config, ctx: SimulationContext | None = None,
            device=None) -> dict:
    """Ground-state SCF. device=None runs on the GPU (and raises without
    CUDA); device="cpu" runs the plain PyTorch versions of the kernels. A
    non-collinear context (num_mag_dims 3) runs dft/scf_nc.py::run_scf_nc.

    Returns the JAX package's result dict for the keys of this slice
    (energies under the reference's names; mag_history and, polarized,
    magnetisation), plus the wall time of each iteration and of each band
    solve."""
    device = resolve_device(device)
    t0 = time.time()
    check_supported(cfg)
    p = cfg.parameters
    if ctx is None:
        ctx = SimulationContext.create(cfg)
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
    # mGGA: tau = 0 before the first band solve (SCAN's alpha = 0 region);
    # the Cartesian G+k vectors of the tau operator, uploaded once
    tau_g = gkc = None
    if mgga:
        tau_g = torch.zeros((ns, ng), dtype=torch.complex128, device=device)
        gkc = torch.as_tensor(np.asarray(ctx.gkvec.gkcart, dtype=np.float64),
                              device=device)
    pot = generate_potential(ctx, rho_g, xc, tables, mag_g, tau_g)
    psi_big = _initial_subspace(ctx)
    psi = None
    # the mixed vector: [rho; m] polarized (scf.py:507-530)
    mixer = Mixer(cfg.mixer, ctx.gvec.glen2, omega=omega, device=device,
                  num_components=2 if polarized else 1)
    x_mix = torch.cat([rho_g, mag_g]) if polarized else rho_g
    path = band_solve_path(cfg, ctx)
    chunk = cfg.control.beta_chunk_size
    prm = gm = gp = x_packed = None
    if path == "chunked":
        # H psi generates the projectors chunk by chunk (K9). The dense
        # table is on the device all the same, as the JAX package's beta_dev
        # is: it gives the preconditioner diagonals (the JAX _h_o_diag) and
        # the ultrasoft density matrix. density_kset reads prm's veff_r,
        # fft_index and mask as it reads HkSetParams'
        prm = ps = make_chunked_hk(ctx, 0, chunk=chunk, device=device)
        beta_dense = torch.as_tensor(
            ctx.beta.beta_gk * ctx.gkvec.mask[:, None, :], device=device)
        prm.o_diag = torch.as_tensor(compute_o_diag(ctx), device=device)
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
        from the current potential (K5 once per spin, on V + B_z and V - B_z
        polarized (scf.py:1236-1243); the bare D of norm-conserving species)
        and h_diag, which reads both."""
        nonlocal d_spin
        v0 = pot.veff_g[0].real
        if aug_tables is not None:
            v_spin = ([pot.veff_g + pot.bz_g, pot.veff_g - pot.bz_g]
                      if polarized else [pot.veff_g])
            d_spin = torch.stack([d_operator_device(v, dion, aug_tables,
                                                    omega) for v in v_spin])
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
        (scf.py:1400-1403)."""
        gp.veff_r = pot.veff_r_coarse[ispn]
        gp.dion = d_spin[ispn].contiguous()
        return gp

    if path == "chunked" or aug_tables is not None:
        # the k-set and Gamma tables of a norm-conserving deck were built
        # from this potential already
        refresh(pot)

    counters = {"num_loc_op_applied": 0}
    etot_history, rms_history, iter_seconds, band_seconds = [], [], [], []
    mag_history = []
    e_prev, converged, rms, scf_correction = None, False, 0.0, 0.0
    mu = entropy_sum = None
    evals = occ = None
    num_iter_done = 0
    res_tol = itsol.residual_tolerance
    for it in range(p.num_dft_iter):
        synchronize(device)
        it_t0 = time.perf_counter()
        if psi_big is not None:
            # first iteration: rotate the full atomic-orbital block down to
            # the lowest nb Ritz vectors (reference initialize_subspace.hpp:279)
            if path == "gamma":
                # one packed block per spin, each rotated under its own
                # potential (scf.py:1404-1420)
                x_packed = []
                for ispn in range(ns):
                    xb = torch.as_tensor(pack(gm, psi_big[0, ispn:ispn + 1]),
                                         device=device)
                    hx, sx = apply_h_s_gamma(gamma_spin(ispn), xb)
                    x_packed.append(subspace_rotate(xb, hx, sx, nb,
                                                    mask=gp.mask_p[None]))
            else:
                big = torch.as_tensor(psi_big, device=device)
                if path == "chunked":
                    xb = big[0] * prm.mask[:, None, :]
                    hx, sx = apply_h_s_chunked(prm, xb)
                    psi = subspace_rotate(xb, hx, sx, nb)[None]
                else:
                    psi = initialize_subspace_kset(ps, big, nb)
                del big
            counters["num_loc_op_applied"] += nk * ns * psi_big.shape[2]
            psi_big = None
        # --- band solve over the whole (k, spin) set ---
        if path == "gamma":
            # packed-real solve per spin (scf.py:1376-1440) with that spin's
            # preconditioner diagonals; the density takes the unpacked bands
            hd_p, od_p = pack_diags(gm, ps.h_diag[0], ps.o_diag.expand(ns, -1))
            evs = []
            for ispn in range(ns):
                ev_s, x_packed[ispn], _ = davidson_gamma(
                    gamma_spin(ispn), x_packed[ispn],
                    hd_p[ispn:ispn + 1], od_p[ispn:ispn + 1],
                    num_steps=itsol.num_steps, res_tol=res_tol)
                evs.append(ev_s)
            ev = torch.cat(evs)
            psi = unpack_device(gp, torch.cat(x_packed))[None]
        elif path == "chunked":
            ev, x, rn = davidson(apply_h_s_chunked, prm, psi[0], prm.h_diag,
                                 prm.o_diag, prm.mask,
                                 num_steps=itsol.num_steps, res_tol=res_tol)
            psi = x[None]
        elif mgga:
            # the tau term in the operator (scf.py:1566-1575)
            ev, psi, rn = davidson_kset_mgga(ps, pot.vtau_r_coarse, gkc, psi,
                                             num_steps=itsol.num_steps,
                                             res_tol=res_tol)
        else:
            ev, psi, rn = davidson_kset(ps, psi, num_steps=itsol.num_steps,
                                        res_tol=res_tol)
        counters["num_loc_op_applied"] += nk * ns * num_applies(itsol.num_steps, nb)
        if path == "kset" and not mgga and cfg.control.scf_supervision:
            _, rn_ok = residual_health(rn, blowup=cfg.control.band_residual_blowup)
            if not rn_ok:
                # one deeper retry, warm-started from the stagnated block (the
                # JAX package retries on this path only, not under mGGA, and
                # only under control.scf_supervision: scf.py:1644)
                ev, psi, rn = davidson_kset(ps, psi,
                                            num_steps=2 * itsol.num_steps,
                                            res_tol=res_tol)
                counters["num_loc_op_applied"] += nk * ns * num_applies(
                    2 * itsol.num_steps, nb)
        evals = ev.reshape(nk, ns, nb)
        synchronize(device)
        band_seconds.append(time.perf_counter() - it_t0)

        # --- occupations and the new density ---
        mu, occ, entropy_sum = find_fermi(
            evals, kweights, nel, p.smearing_width, kind=p.smearing,
            max_occupancy=ctx.max_occupancy)
        occ_w = occ * kweights[:, None, None]
        rho_spin = density_from_coarse_acc(ctx, density_kset(ps, psi, occ_w),
                                           tables)
        if mgga:
            # tau of the current bands, symmetrized as a scalar field per
            # spin; not mixed: the potential takes the mixed rho with this
            # fresh tau (scf.py:1949-1969)
            tau_g = density_from_coarse_acc(ctx, tau_kset(ps, gkc, psi, occ_w),
                                            tables)
            if tables.sym is not None:
                tau_g = symmetrize_tau(tables.sym, tau_g)
        if aug_tables is not None:
            # beta density matrix -> its space-group average -> rho_aug (K4)
            dm = density_matrix_kset(beta_dense, psi, occ_w)
            if dm_sym is not None:
                dm = symmetrize_density_matrix_device(dm, dm_sym)
            rho_spin += rho_aug_g_device(dm.contiguous(), aug_tables,
                                         ctx.gvec.num_gvec)
        rho_new = rho_spin.sum(dim=0)
        mag_new = rho_spin[0] - rho_spin[1] if polarized else None
        if tables.sym is not None:
            rho_new = symmetrize_pw(tables.sym, rho_new)
            if polarized:
                mag_new = symmetrize_pw(tables.sym, mag_new, axial_z=True)
        x_new = torch.cat([rho_new, mag_new]) if polarized else rho_new
        if not (bool(torch.all(torch.isfinite(evals))) and bool(
                torch.all(torch.isfinite(torch.view_as_real(x_new))))):
            raise FloatingPointError(
                f"non-finite band energies or density at SCF iteration {it + 1}")

        # --- mixing ---
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
        pot = generate_potential(ctx, rho_g, xc, tables, mag_g, tau_g)
        if not bool(torch.all(torch.isfinite(pot.veff_r_coarse))):
            raise FloatingPointError(
                f"non-finite effective potential at SCF iteration {it + 1}")
        refresh(pot)
        scf_correction = _epot(pot) - e1 if p.use_scf_correction else 0.0
        eval_sum = float(torch.sum(kweights[:, None, None] * occ * evals))
        e = pot.energies
        e_total = (eval_sum - e["vxc"] - e["bxc"] - e["vtau_tau"]
                   - 0.5 * e["vha"] + e["exc"] + ctx.e_ewald + scf_correction)
        etot_history.append(e_total + float(entropy_sum))
        rms_history.append(rms)
        if polarized:
            # the total moment of the output density, before mixing
            mag_history.append(float(mag_new[0].real) * omega)
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
    e_total = (eval_sum - e["vxc"] - e["bxc"] - e["vtau_tau"]
               - 0.5 * e["vha"] + e["exc"] + ctx.e_ewald + scf_correction)
    rho_r = rho_real_space(tables, rho_g)
    result = {
        "converged": converged,
        "num_scf_iterations": num_iter_done,
        "efermi": 0.0 if mu is None else float(mu),
        "band_gap": _band_gap(evals_np, occ_np, ctx),
        "rho_min": float(rho_r.min()),
        "etot_history": etot_history,
        "rms_history": rms_history,
        "mag_history": mag_history,
        "scf_time": time.time() - t0,
        "iteration_seconds": iter_seconds,
        "band_solve_seconds": band_seconds,
        "device": str(device),
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
        "_state": {"rho_g": rho_g, "mag_g": mag_g, "psi": psi},
    }
    if polarized:
        mag_np = mag_g.cpu().numpy()
        result["magnetisation"] = {
            "total": [0.0, 0.0, float(mag_np[0].real) * omega],
            "atoms": [[0.0, 0.0, float(mz)]
                      for mz in atomic_moments(ctx, mag_np)],
        }
    return result
