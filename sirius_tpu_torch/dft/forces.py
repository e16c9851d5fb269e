"""Atomic forces for the PP-PW method.

Reference: src/geometry/force.cpp — total = vloc + ewald + core (NLCC) +
nonloc + us (augmentation) + scf_corr contributions (force.hpp:44-66),
symmetrized over the space group.

Mirrors sirius_tpu/dft/forces.py without the Hubbard term (Hubbard is
refused by dft/scf.py::check_supported). The G-space sums of the local,
core, scf-correction, Ewald and augmentation terms are host numpy over
precomputed tables, by copy. The non-local term reads the bands where they
are (on the card): <beta|psi> and <beta|(G+k)_i|psi> are matrix products
(cuBLAS) per (k, spin), the analytic -i(G+k) factor in place of the
reference's gradient projectors (beta_projectors_gradient.hpp).

Conventions: forces in Ha/bohr, Cartesian, one row per atom.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfc

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.dft.ewald import ewald_lambda
from sirius_tpu_torch.dft.radial_tables import rho_core_form_factor, vloc_ff

# bands whose weighted occupation is below this carry no force
# (sirius_tpu/dft/forces.py:144)
OCC_CUTOFF = 1e-14


def _form_factor_force(
    ctx: SimulationContext, field_g: np.ndarray, ff_fn, skip=lambda t: False
) -> np.ndarray:
    """Shared shell-form-factor force kernel:
    F_a = Re sum_G 4 pi conj(field(G)) ff_a(|G|) iG e^{-i G r_a}."""
    uc = ctx.unit_cell
    out = np.zeros((uc.num_atoms, 3))
    qshell = np.sqrt(ctx.gvec.shell_g2)
    for it, t in enumerate(uc.atom_types):
        if skip(t):
            continue
        ff = np.asarray(ff_fn(t, qshell))[ctx.gvec.shell_idx]
        for ia in uc.atoms_of_type(it):
            phase = np.exp(-2j * np.pi * (ctx.gvec.millers @ uc.positions[ia]))
            w = 4.0 * np.pi * np.conj(field_g) * ff * phase
            out[ia] = np.real(1j * (w[:, None] * ctx.gvec.gcart).sum(axis=0))
    return out


def forces_vloc(ctx: SimulationContext, rho_g: np.ndarray) -> np.ndarray:
    """Local-potential force (reference force.cpp calc_forces_vloc)."""
    return _form_factor_force(ctx, rho_g, vloc_ff(ctx.cfg.settings.pseudo_grid_cutoff))


def forces_core(ctx: SimulationContext, vxc_g: np.ndarray) -> np.ndarray:
    """NLCC force: core density against V_xc (reference calc_forces_core)."""
    return _form_factor_force(
        ctx, vxc_g, rho_core_form_factor, skip=lambda t: t.rho_core is None
    )


def forces_scf_corr(ctx: SimulationContext, rho_resid_g: np.ndarray) -> np.ndarray:
    """First-order correction for incomplete SCF: the local-potential force
    of the density residual rho_out - rho_in (reference calc_forces_scf_corr);
    vanishes at convergence."""
    return _form_factor_force(
        ctx, rho_resid_g, vloc_ff(ctx.cfg.settings.pseudo_grid_cutoff)
    )


def forces_ewald(ctx: SimulationContext) -> np.ndarray:
    """Point-ion Ewald forces (reference calc_forces_ewald)."""
    uc = ctx.unit_cell
    gv = ctx.gvec
    omega = uc.omega
    z = np.asarray([uc.atom_types[t].zn for t in uc.type_of_atom])
    lam = ewald_lambda(ctx.cfg.parameters.pw_cutoff, omega)
    natom = uc.num_atoms
    out = np.zeros((natom, 3))
    # G-space: F_a = (4 pi / Omega) z_a sum_G!=0 G e^{-G^2/4lam}/G^2
    #                Im[e^{-i G r_a} S(G)]
    g2 = gv.glen2[1:]
    phases = np.exp(2j * np.pi * (gv.millers[1:] @ uc.positions.T))  # (ng, na)
    s = phases @ z
    w = np.exp(-g2 / (4 * lam)) / g2
    for ia in range(natom):
        # F_a = (4 pi/Omega) z_a sum_G w G Im[e^{iG r_a} conj(S)]
        t = np.imag(phases[:, ia] * np.conj(s)) * w
        out[ia] = (4.0 * np.pi / omega) * z[ia] * (t[:, None] * gv.gcart[1:]).sum(axis=0)
    # real-space
    rc = 10.0 / np.sqrt(lam)
    inv = np.linalg.inv(uc.lattice)
    nmax = np.ceil(rc * np.linalg.norm(inv, axis=0)).astype(int) + 1
    ts = np.array(
        np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing="ij")
    ).reshape(3, -1).T
    tcart = ts @ uc.lattice
    pos = uc.positions_cart()
    d = pos[:, None, None, :] - pos[None, :, None, :] - tcart[None, None, :, :]
    dist = np.linalg.norm(d, axis=-1)
    mask = (dist > 1e-10) & (dist < rc)
    a = np.sqrt(lam)
    with np.errstate(divide="ignore", invalid="ignore"):
        scal = np.where(
            mask,
            (erfc(a * dist) / dist + 2 * a / np.sqrt(np.pi) * np.exp(-lam * dist**2))
            / np.where(mask, dist**2, 1.0),
            0.0,
        )
    zz = z[:, None, None] * z[None, :, None]
    out += np.einsum("abt,abti->ai", zz * scal, d)
    return out


def forces_nonloc(
    ctx: SimulationContext,
    psi: torch.Tensor,  # [nk, ns, nb, ngk]
    occ: np.ndarray,  # [nk, ns, nb]
    evals: np.ndarray,  # [nk, ns, nb]
    d_by_spin: list[np.ndarray],
    beta: torch.Tensor | None = None,  # [nk, nbeta, ngk] on psi's device
) -> np.ndarray:
    """Beta-projector force: F_a,i = -2 Re sum_{k,s,b} w f
    conj(<d_i beta|psi>) (D - eps Q) <beta|psi> summed over a's projectors;
    d_i beta = -i (G+k)_i beta (reference non_local_functor.hpp).

    Runs on psi's device: per (k, spin) the products <beta|psi> and
    <beta|(G+k)_i|psi> in complex128 (a complex64 psi is widened first, as
    the JAX package's einsum promotes it), then every band at once, the
    bands with |w f| < OCC_CUTOFF masked out as the JAX package skips them.
    beta: the dense projector table on the device, if the caller has it;
    else ctx.beta.beta_gk is uploaded."""
    uc = ctx.unit_cell
    nbeta = ctx.beta.num_beta_total
    out = np.zeros((uc.num_atoms, 3))
    if nbeta == 0:
        return out
    dev = psi.device
    if beta is None:
        beta = torch.as_tensor(ctx.beta.beta_gk, device=dev)
    beta = beta.to(torch.complex128)
    gk_all = torch.as_tensor(np.asarray(ctx.gkvec.gkcart, dtype=np.float64),
                             device=dev)
    qmat = (None if ctx.beta.qmat is None else
            torch.as_tensor(ctx.beta.qmat, dtype=torch.complex128, device=dev))
    w = np.asarray(occ, dtype=np.float64) * ctx.gkvec.weights[:, None, None]
    # per-projector force [3, nbeta], summed over the atoms' blocks at the end
    acc = torch.zeros((3, nbeta), dtype=torch.float64, device=dev)
    for ik in range(ctx.gkvec.num_kpoints):
        bc = beta[ik].conj()  # (nbeta, ngk)
        # <beta| (G+k)_i: the three rows of the gradient projector
        bg = bc[None] * gk_all[ik].T[:, None, :]  # (3, nbeta, ngk)
        for ispn in range(psi.shape[1]):
            ps = psi[ik, ispn].to(torch.complex128).T  # (ngk, nb)
            bp = bc @ ps  # <beta|psi> (nbeta, nb)
            bpg = bg @ ps  # <beta|(G+k)_i|psi> (3, nbeta, nb)
            d = torch.as_tensor(np.asarray(d_by_spin[ispn]),
                                dtype=torch.complex128, device=dev)
            eff = d @ bp  # (D - eps Q) <beta|psi>, every band
            if qmat is not None:
                eps = torch.as_tensor(np.asarray(evals[ik, ispn]),
                                      dtype=torch.float64, device=dev)
                eff = eff - (qmat @ bp) * eps[None, :]
            f = w[ik, ispn]
            f = torch.as_tensor(np.where(np.abs(f) < OCC_CUTOFF, 0.0, f),
                                dtype=torch.float64, device=dev)
            # 2 Re(conj(i <beta|(G+k)_i|psi>) eff) = 2 Im(conj(bpg) eff)
            acc += 2.0 * ((bpg.conj() * eff[None]).imag * f).sum(dim=-1)
    per_beta = acc.cpu().numpy()
    for ia, off, nbf in ctx.beta.atom_blocks(uc):
        out[ia] -= per_beta[:, off : off + nbf].sum(axis=1)
    return out


def forces_us(
    ctx: SimulationContext,
    veff_g: np.ndarray,
    bz_g: np.ndarray | None,
    dm_blocks_by_spin: list,
) -> np.ndarray:
    """Augmentation force: the Q(G) charge moving with the atom against the
    effective potential (reference calc_forces_us):
    F_a = -Omega Re sum_G conj(V^s(G)) n^a Q(G) (-iG) e^{-i G r_a}."""
    uc = ctx.unit_cell
    out = np.zeros((uc.num_atoms, 3))
    if ctx.aug is None:
        return out
    ns = len(dm_blocks_by_spin)
    for ispn in range(ns):
        vs = veff_g if bz_g is None else (veff_g + bz_g if ispn == 0 else veff_g - bz_g)
        for it, at in enumerate(ctx.aug.per_type):
            if at is None:
                continue
            w2 = np.where(at.xi1 == at.xi2, 1.0, 2.0)
            for ia in uc.atoms_of_type(it):
                dmp = w2 * np.real(dm_blocks_by_spin[ispn][ia][at.xi1, at.xi2])
                phase = np.exp(-2j * np.pi * (ctx.gvec.millers @ uc.positions[ia]))
                qn = dmp @ at.q_pw  # (ng,)
                w = uc.omega * np.conj(vs) * qn * phase
                out[ia] += np.real(1j * (w[:, None] * ctx.gvec.gcart).sum(axis=0))
    return out


def symmetrize_forces(ctx: SimulationContext, f: np.ndarray) -> np.ndarray:
    """F'_{perm[a]} = R F_a averaged over ops (reference
    symmetrize_forces.hpp)."""
    if ctx.symmetry is None or ctx.symmetry.num_ops <= 1:
        return f
    out = np.zeros_like(f)
    for op in ctx.symmetry.ops:
        out[op.perm] += f @ op.rot_cart.T
    return out / ctx.symmetry.num_ops


def total_forces(
    ctx: SimulationContext,
    rho_g: np.ndarray,
    vxc_g: np.ndarray,
    veff_g: np.ndarray,
    bz_g,
    psi: torch.Tensor,
    occ,
    evals,
    d_by_spin,
    dm_blocks_by_spin,
    rho_resid_g: np.ndarray | None = None,
    beta: torch.Tensor | None = None,
) -> dict:
    """Every force term [natom, 3] by name and their symmetrized sum
    ("total"). The fields are host arrays on the fine G set; psi is on the
    device of the bands (forces_nonloc)."""
    terms = {
        "vloc": forces_vloc(ctx, rho_g),
        "core": forces_core(ctx, vxc_g),
        "ewald": forces_ewald(ctx),
        "nonloc": forces_nonloc(ctx, psi, occ, evals, d_by_spin, beta=beta),
        "us": forces_us(ctx, veff_g, bz_g, dm_blocks_by_spin),
    }
    if rho_resid_g is not None:
        terms["scf_corr"] = forces_scf_corr(ctx, rho_resid_g)
    tot = sum(terms.values())
    terms["total"] = symmetrize_forces(ctx, tot)
    return terms
