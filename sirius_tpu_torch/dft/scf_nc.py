"""Non-collinear SCF ground-state driver (num_mag_dims = 3).

Mirrors sirius_tpu/dft/scf_nc.py::run_scf_nc on device tensors: one
flattened spinor band set per k-point ([nb, 2 ngk]), the four-component
density (rho, m_x, m_y, m_z), the vector B_xc of the locally diagonal XC
projection and the spin-block D and Q operators (reference
dft_ground_state.cpp:178-427 with the num_mag_dims() == 3 branches of
density.cpp, potential/xc.cpp and local_operator.cpp). The band solve is one
batched Davidson over the k-set (parallel/batched_nc.py); D is K5 four times
an iteration (D(V) with D_ion, D(B_x), D(B_y), D(B_z) without), rho_aug K4
once over the four Hermitian component blocks, the symmetrization K6 (rho,
V_eff) and K6v (m, B). As in the JAX package the loop runs no band-solve
retry, and spin-orbit is refused (it needs j-resolved projectors, which
only UPF species carry).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.device import synchronize
from sirius_tpu_torch.dft.density import (
    atomic_moments_vec,
    build_dm_sym_tables,
    density_from_coarse_acc,
    dm_component_blocks,
    grid_tables,
    initial_density_g,
    initial_magnetization_vec_g,
    rho_real_space,
    symmetrize_density_matrix_nc_device,
    symmetrize_pw,
)
from sirius_tpu_torch.dft.mixer import Mixer, schedule_res_tol
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.dft.potential_nc import (
    generate_potential_nc,
    symmetrize_vector_pw,
)
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.ops.atomic import atomic_orbitals
from sirius_tpu_torch.ops.augmentation import (
    build_aug_device_tables,
    d_operator_device,
    rho_aug_g_device,
)
from sirius_tpu_torch.ops.spinor import spin_blocks_from_components
from sirius_tpu_torch.parallel.batched_nc import (
    davidson_kset_nc,
    density_kset_nc,
    density_matrix_kset_nc,
    make_nc_set_params,
)
from sirius_tpu_torch.solvers.davidson import num_applies


def _initial_spinors(ctx: SimulationContext) -> np.ndarray:
    """LCAO spinors [nk, nb, 2 ngk]: orbital j fills bands 2j (up) and
    2j+1 (down); the rest are damped-random in both components. A copy of
    the JAX function (np.random.default_rng(42), the same order), so both
    packages start from the same block."""
    nk = ctx.gkvec.num_kpoints
    nb = ctx.num_bands
    ngk = ctx.gkvec.ngk_max
    ao = atomic_orbitals(ctx.unit_cell, ctx.gkvec, ctx.cfg.parameters.gk_cutoff + 1e-9)
    rng = np.random.default_rng(42)
    psi = np.zeros((nk, nb, 2, ngk), dtype=np.complex128)
    nao = ao.shape[1]
    for ik in range(nk):
        j = 0
        for b in range(nb):
            if j < nao:
                psi[ik, b, b % 2] = ao[ik, j]
                if b % 2 == 1:
                    j += 1
            else:
                damp = 1.0 / (1.0 + ctx.gkvec.kinetic()[ik])
                psi[ik, b, :] = (
                    rng.standard_normal((2, ngk))
                    + 1j * rng.standard_normal((2, ngk))
                ) * damp
        psi[ik] *= ctx.gkvec.mask[ik][None, None, :]
    return psi.reshape(nk, nb, 2 * ngk)


def run_scf_nc(cfg: Config, ctx: SimulationContext, device) -> dict:
    """The non-collinear ground state on ``device`` (resolved by the caller,
    dft/scf.py::run_scf). Returns the JAX package's result dict (energies,
    the magnetisation as vectors) plus the wall time of each iteration and
    of each band solve."""
    t0 = time.time()
    p = cfg.parameters
    assert ctx.num_mag_dims == 3
    xc = XCFunctional(p.xc_functionals)
    if xc.is_mgga:
        # the spinor operator has no tau term (scf_nc.py:103-106)
        raise NotImplementedError("mGGA with non-collinear magnetism")
    nk, nb = ctx.gkvec.num_kpoints, ctx.num_bands
    nel = ctx.unit_cell.num_valence_electrons - p.extra_charge
    if nb * ctx.max_occupancy < nel - 1e-12:
        raise ValueError(f"num_bands={nb} cannot hold {nel} electrons (spinor)")
    itsol = cfg.iterative_solver
    omega = ctx.unit_cell.omega
    tables = grid_tables(ctx, device)
    kweights = torch.as_tensor(ctx.kweights, dtype=torch.float64, device=device)
    ng = ctx.gvec.num_gvec

    rho_g = torch.as_tensor(initial_density_g(ctx), dtype=torch.complex128,
                            device=device)
    mvec_g = torch.as_tensor(initial_magnetization_vec_g(ctx),
                             dtype=torch.complex128, device=device)
    psi = torch.as_tensor(_initial_spinors(ctx), device=device)
    pot = generate_potential_nc(ctx, rho_g, xc, mvec_g, tables)
    mixer = Mixer(cfg.mixer, ctx.gvec.glen2, omega=omega, device=device,
                  num_components=4)
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=device)
    zero_d = torch.zeros_like(dion)
    aug_tables = dm_sym = None
    if ctx.aug is not None:
        aug_tables = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug,
                                             ctx.beta, device)
        if tables.sym is not None:
            dm_sym = build_dm_sym_tables(ctx, device)

    def pack(r, m):
        return torch.cat([r, m.reshape(-1)])

    def unpack(x):
        return x[:ng], x[ng:].view(3, ng)

    x_mix = pack(rho_g, mvec_g)
    ps = None  # the band solve's tables; the constant ones are reused
    counters = {"num_loc_op_applied": 0}
    etot_history, rms_history, iter_seconds, band_seconds = [], [], [], []
    e_prev, converged, rms, scf_correction = None, False, 0.0, 0.0
    mu = entropy_sum = evals = occ = None
    num_iter_done = 0
    res_tol = itsol.residual_tolerance
    for it in range(p.num_dft_iter):
        synchronize(device)
        it_t0 = time.perf_counter()
        # --- the spin-block D operator (K5 four times with augmentation) ---
        if aug_tables is not None:
            d0 = d_operator_device(pot.veff_g, dion, aug_tables, omega)
            dx, dy, dz = (d_operator_device(pot.bvec_g[i], zero_d, aug_tables,
                                            omega) for i in range(3))
        else:
            d0, dx, dy, dz = dion, zero_d, zero_d, zero_d
        dmat = spin_blocks_from_components(d0, dz, dx, dy)
        ps = make_nc_set_params(ctx, pot.veff_boxes, dmat,
                                v0=pot.veff_g[0].real, prev=ps, device=device)
        evals, psi, _ = davidson_kset_nc(ps, psi, num_steps=itsol.num_steps,
                                         res_tol=res_tol)
        counters["num_loc_op_applied"] += nk * num_applies(itsol.num_steps, nb)
        synchronize(device)
        band_seconds.append(time.perf_counter() - it_t0)

        # --- occupations: spinor bands hold one electron each ---
        mu, occ, entropy_sum = find_fermi(
            evals[:, None, :], kweights, nel, p.smearing_width, kind=p.smearing,
            max_occupancy=1.0)
        occ_w = occ[:, 0, :] * kweights[:, None]

        # --- the four-component density, (rho, m_z, m_x, m_y) on the box ---
        fields = density_from_coarse_acc(ctx, density_kset_nc(ps, psi, occ_w),
                                         tables)
        rho_new = fields[0]
        mvec_new = torch.stack([fields[2], fields[3], fields[1]])
        if aug_tables is not None:
            dm3 = density_matrix_kset_nc(ps.beta, psi, occ_w)
            if dm_sym is not None:
                dm3 = symmetrize_density_matrix_nc_device(dm3, dm_sym)
            aug = rho_aug_g_device(dm_component_blocks(dm3).contiguous(),
                                   aug_tables, ng)
            rho_new = rho_new + aug[0]
            mvec_new = mvec_new + aug[1:]
        if tables.sym is not None:
            rho_new = symmetrize_pw(tables.sym, rho_new)
            mvec_new = symmetrize_vector_pw(tables.sym, mvec_new)
        x_new = pack(rho_new, mvec_new)
        if not (bool(torch.all(torch.isfinite(evals))) and bool(
                torch.all(torch.isfinite(torch.view_as_real(x_new))))):
            raise FloatingPointError(
                f"non-collinear SCF diverged at iteration {it + 1}: "
                "non-finite band energies or density")

        # --- mixing ---
        rms = mixer.rms(x_mix, x_new)
        x_mix = mixer.mix(x_mix, x_new)
        eha_res = mixer.residual_hartree_energy(x_mix, x_new)
        dens_metric = eha_res if mixer.use_hartree else rms
        res_tol = schedule_res_tol(itsol, res_tol, dens_metric, nel,
                                   mixer.use_hartree)
        rho_g, mvec_g = unpack(x_mix)

        # E_pot[rho_out, m_out] under the new vs the old potential
        # (scf_nc.py:309-324)
        def _epot(p_):
            e = float(torch.vdot(rho_new, p_.veff_g).real) * omega
            e += sum(float(torch.vdot(mvec_new[i], p_.bvec_g[i]).real) * omega
                     for i in range(3))
            return e

        e1 = _epot(pot)
        pot = generate_potential_nc(ctx, rho_g, xc, mvec_g, tables)
        if not bool(torch.all(torch.isfinite(pot.veff_boxes))):
            raise FloatingPointError(
                f"non-finite effective potential at SCF iteration {it + 1}")
        scf_correction = _epot(pot) - e1 if p.use_scf_correction else 0.0
        eval_sum = float(torch.sum(kweights[:, None] * occ[:, 0, :] * evals))
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
    e = pot.energies
    ent = 0.0 if entropy_sum is None else float(entropy_sum)
    eval_sum = (0.0 if evals is None else
                float(torch.sum(kweights[:, None] * occ[:, 0, :] * evals)))
    e_total = (eval_sum - e["vxc"] - e["bxc"] - 0.5 * e["vha"] + e["exc"]
               + ctx.e_ewald + scf_correction)
    mvec_np = mvec_g.cpu().numpy()
    return {
        "converged": converged,
        "num_scf_iterations": num_iter_done,
        "rho_min": float(rho_real_space(tables, rho_g).min()),
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
        },
        "efermi": 0.0 if mu is None else float(mu),
        "band_gap": 0.0,
        "magnetisation": {
            # the cell integral of m: its G = 0 term
            "total": [float(mvec_np[i][0].real) * omega for i in range(3)],
            "atoms": [list(map(float, m))
                      for m in atomic_moments_vec(ctx, mvec_np)],
        },
        "counters": counters,
        "_state": {"rho_g": rho_g, "mvec_g": mvec_g, "psi": psi},
    }
