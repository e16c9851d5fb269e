"""Stress tensor for the PP-PW method.

Reference: src/geometry/stress.cpp — sigma = kin + har + ewald + vloc +
nonloc + us + xc + core (stress.hpp:96-114), symmetrized.

Convention: sigma_ab = (1/Omega) dF/d eps_ab for r -> (1+eps) r at frozen
wave-function PW coefficients and occupations. Under that strain the
reciprocal vectors move as B -> B (1+eps)^{-1}, Miller indices / structure
phases e^{-2 pi i m.x} are invariant, the valence density coefficients
rescale as rho(G) -> rho(G) Omega0/Omega, and atom-attached form-factor
fields carry their 4pi/Omega prefactor.

Each term's frozen-coefficient energy functional is written exactly for a
strained lattice and differentiated by central differences in the 6
independent strain components (O(h^2), h = 1e-5); the kinetic term is in
closed form. Ultrasoft augmentation: at frozen density-matrix blocks the
augmentation charge rho_aug(eps, G) is rebuilt from strained Q(G) tables
inside the Hartree, local and XC functionals, which is the reference's
sigma_us term distributed over them.

Mirrors sirius_tpu/dft/stress.py without the Hubbard term (refused by
dft/scf.py::check_supported). The strained tables, the Hartree, local,
Ewald and non-local functionals and the kinetic term are host numpy, by
copy; the bands are copied to the host once a stress. On the card the XC
functional runs at each strain point on the device: the strained
densities through K1 and cuFFT (core/fftgrid.py::g_to_r), GGA's strained
gradients as one K10a launch on the strained G with cuFFT, the XC through
K7 / K7b (LDA) or K7g from the gradients (GGA), and the strained
augmentation charge through K4 on strained Q(G) tables, charge and
magnetization in one launch. On the CPU the XC takes the sigma form and
the augmentation charge the host rho_aug_g, as the JAX package does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.core.fftgrid import g_to_r
from sirius_tpu_torch.core.sht import lm_index, ylm_real
from sirius_tpu_torch.device import resolve_device, synchronize
from sirius_tpu_torch.dft.ewald import ewald_energy
from sirius_tpu_torch.dft.radial_tables import (
    rho_core_form_factor,
    structure_factors,
    vloc_ff,
)
from sirius_tpu_torch.kernels.xc_gradient import gradient_boxes
from sirius_tpu_torch.ops.augmentation import (
    aug_radial_tables,
    build_aug_device_tables,
    q_pw_at,
    rho_aug_g,
    rho_aug_g_device,
    with_q_tables,
)
from sirius_tpu_torch.ops.beta import beta_radial_table

_H = 1e-5


def _strained(lattice: np.ndarray, eps: np.ndarray) -> np.ndarray:
    return lattice @ (np.eye(3) + eps).T  # rows a_i -> (1+eps) a_i


def _ff_table(ff_fn, t, qmax: float):
    """Dense spline table of a form factor, evaluable at arbitrary q."""
    from scipy.interpolate import CubicSpline

    q = np.linspace(0.0, qmax, max(256, int(qmax * 24)))
    return CubicSpline(q, np.asarray(ff_fn(t, q)))


def dm_block_matrix(ctx: SimulationContext, blocks: list) -> np.ndarray:
    """The per-atom density-matrix blocks as one block-diagonal
    [nbeta, nbeta] matrix, the layout K4 reads."""
    nbeta = ctx.beta.num_beta_total
    out = np.zeros((nbeta, nbeta), dtype=np.complex128)
    for ia, off, nbf in ctx.beta.atom_blocks(ctx.unit_cell):
        out[off:off + nbf, off:off + nbf] = blocks[ia]
    return out


class StressCalculator:
    """Per-term sigma via central differences of exact strained functionals.

    device: where the XC functional and the strained augmentation charge
    run (the card unless the caller asks for the CPU). tables: the SCF's
    dft/density.py::GridTables on that device, if the caller has them (the
    fine FFT index and its inverse are read); aug_tables: its
    build_aug_device_tables, likewise. seconds: the host seconds of each
    term of the last compute, each ending in a synchronize."""

    def __init__(self, ctx: SimulationContext, xc, device=None, tables=None,
                 aug_tables=None):
        self.ctx = ctx
        self.xc = xc
        self.device = resolve_device(device)
        self.seconds: dict = {}
        uc = ctx.unit_cell
        self.sfact = structure_factors(uc, ctx.gvec)
        qmax_fine = ctx.cfg.parameters.pw_cutoff * 1.05
        qmax_gk = ctx.cfg.parameters.gk_cutoff * 1.05
        self.vloc_tab = [
            _ff_table(
                vloc_ff(ctx.cfg.settings.pseudo_grid_cutoff), t, qmax_fine
            )
            for t in uc.atom_types
        ]
        self.core_tab = [
            _ff_table(rho_core_form_factor, t, qmax_fine) if t.rho_core is not None else None
            for t in uc.atom_types
        ]
        self.beta_tab = [beta_radial_table(t, qmax_gk) for t in uc.atom_types]
        if ctx.aug is not None:
            self.aug_tabs = [
                aug_radial_tables(t, qmax_fine) if t.augmentation else None
                for t in uc.atom_types
            ]
        else:
            self.aug_tabs = None
        dev = self.device
        if tables is not None:
            self.fidx, self.box_to_g = tables.fft_index, tables.box_to_g
        else:
            box_to_g = np.full(ctx.gvec.fft.num_points, -1, dtype=np.int32)
            box_to_g[ctx.gvec.fft_index] = np.arange(ctx.gvec.num_gvec,
                                                     dtype=np.int32)
            self.fidx = torch.as_tensor(ctx.gvec.fft_index, device=dev)
            self.box_to_g = torch.as_tensor(box_to_g, device=dev)
        self.dims = tuple(ctx.gvec.fft.dims)
        # K4's tables on the card; the CPU runs the host rho_aug_g
        self.aug_dev = None
        if ctx.aug is not None and dev.type != "cpu":
            self.aug_dev = (aug_tables if aug_tables is not None else
                            build_aug_device_tables(uc, ctx.gvec, ctx.aug,
                                                    ctx.beta, dev))

    # --- strained geometric tables -------------------------------------
    def _recip(self, eps):
        return 2.0 * np.pi * np.linalg.inv(_strained(self.ctx.unit_cell.lattice, eps)).T

    def _gcart(self, eps):
        return self.ctx.gvec.millers @ self._recip(eps)

    def _gkcart(self, eps):
        b = self._recip(eps)
        mk = self.ctx.gkvec.millers + self.ctx.gkvec.kpoints[:, None, :]
        return (mk @ b) * self.ctx.gkvec.mask[..., None]

    def _omega(self, eps):
        return float(abs(np.linalg.det(_strained(self.ctx.unit_cell.lattice, eps))))

    # --- strained augmentation charge ----------------------------------
    def strained_q(self, eps) -> list:
        """Q(G) of every type on the strained lattice (None where a type
        has no augmentation)."""
        ctx = self.ctx
        uc = ctx.unit_cell
        gc = self._gcart(eps)
        om = self._omega(eps)
        return [
            None
            if at is None
            else q_pw_at(uc.atom_types[it], self.aug_tabs[it], gc, om)
            for it, at in enumerate(ctx.aug.per_type)
        ]

    def _rho_aug_eps(self, eps) -> list:
        """rho_aug(eps, G) at frozen per-atom dm blocks for each density
        component (charge: dm_up + dm_dn; then, polarized, the
        magnetization: dm_up - dm_dn): on the card one K4 launch a type
        for every component on the strained Q(G) tables (device tensors),
        on the CPU the host rho_aug_g of each (numpy), as the JAX package
        assembles them."""
        ctx = self.ctx
        q_by_type = self.strained_q(eps)
        if self.aug_dev is None:
            return [rho_aug_g(ctx.unit_cell, ctx.gvec, ctx.aug, dm,
                              q_by_type)
                    for dm in self._dm_comps]
        q = [torch.as_tensor(x, device=self.device)
             for x in q_by_type if x is not None]
        out = rho_aug_g_device(self._dm_dev, with_q_tables(self.aug_dev, q),
                               ctx.gvec.num_gvec)
        return list(out)

    def _density_eps(self, eps):
        """(rho(eps, G), mag(eps, G)) on the device, and their host copies:
        frozen psi-part coefficients scale with Omega0/Omega; the
        augmentation part is rebuilt from strained Q(G) at frozen dm.
        Memoized per strain point (three functionals consume the same
        densities)."""
        key = eps.tobytes()
        hit = self._density_eps_cache.get(key)
        if hit is not None:
            return hit
        scale = self.ctx.unit_cell.omega / self._omega(eps)
        aug = self._rho_aug_eps(eps) if self._dm_comps else []
        aug += [0.0] * (2 - len(aug))
        # host arrays, or device tensors where K4 builds the charge
        fields = [None if ref is None else (ref - aug0) * scale + a
                  for ref, aug0, a in zip(self._refs, self._aug0, aug)]
        host = [f.cpu().numpy() if isinstance(f, torch.Tensor) else f
                for f in fields]
        dev = [torch.as_tensor(f, device=self.device)
               if isinstance(f, np.ndarray) else f for f in fields]
        hit = (*host, *dev)
        self._density_eps_cache[key] = hit
        return hit

    # --- frozen-coefficient energy functionals -------------------------
    def e_hartree(self, eps):
        rho = self._density_eps(eps)[0]
        g2 = np.sum(self._gcart(eps) ** 2, axis=1)[1:]
        return 2.0 * np.pi * self._omega(eps) * float(
            np.sum(np.abs(rho[1:]) ** 2 / g2)
        )

    def e_vloc(self, eps):
        rho = self._density_eps(eps)[0]
        glen = np.sqrt(np.sum(self._gcart(eps) ** 2, axis=1))
        acc = 0.0
        for it in range(len(self.ctx.unit_cell.atom_types)):
            ff = self.vloc_tab[it](glen)
            acc += float(np.real(np.vdot(rho, ff * np.conj(self.sfact[it]))))
        return 4.0 * np.pi * acc

    def e_ewald(self, eps):
        uc = self.ctx.unit_cell
        z = np.asarray([uc.atom_types[t].zn for t in uc.type_of_atom])
        return ewald_energy(
            _strained(uc.lattice, eps), uc.positions, z,
            self._gcart(eps), self.ctx.gvec.millers, self.ctx.cfg.parameters.pw_cutoff,
        )

    def _gradients(self, fields: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
        """grad f on the strained lattice of fields [S, ng] as real boxes
        [S, 3, N]: the boxes of i G_s f (K10a, one launch for every field)
        and the inverse FFTs."""
        n = self.dims[0] * self.dims[1] * self.dims[2]
        s = fields.shape[0]
        box = gradient_boxes(fields, gc, self.fidx, n, self.box_to_g)
        fr = torch.fft.ifftn(box.view((s, 3) + self.dims), dim=(-3, -2, -1),
                             norm="forward")
        return fr.real.reshape(s, 3, n)

    def e_xc(self, eps):
        """E_xc[rho(eps) + rho_core(eps)]; valence density from
        _density_eps (psi-part scaling + strained augmentation), core
        rebuilt from its strained form factors. The density floor and the
        moment clip are the JAX package's (stress.py:219, :230-231),
        applied before the XC kernel."""
        ctx = self.ctx
        dev = self.device
        om = self._omega(eps)
        gc_np = self._gcart(eps)
        glen = np.sqrt(np.sum(gc_np ** 2, axis=1))
        core_g = np.zeros(ctx.gvec.num_gvec, dtype=np.complex128)
        for it in range(len(ctx.unit_cell.atom_types)):
            if self.core_tab[it] is not None:
                core_g += self.core_tab[it](glen) * np.conj(self.sfact[it])
        core_g *= 4.0 * np.pi / om
        has_core = bool(np.any(core_g))
        core_d = torch.as_tensor(core_g, device=dev)

        def to_r(f_g):
            return g_to_r(f_g, self.fidx, self.dims).real

        _, _, rho_eps_g, mag_eps_g = self._density_eps(eps)
        core_r = to_r(core_d) if has_core else 0.0
        rho_r = to_r(rho_eps_g)
        n = rho_r.numel()
        plain = dev.type == "cpu"  # the sigma form of the JAX package
        gc = (torch.as_tensor(gc_np, device=dev)
              if self.xc.is_gga else None)

        if mag_eps_g is None:
            rho = torch.clamp(rho_r + core_r, min=1e-25).reshape(-1)
            if self.xc.is_gga:
                g = self._gradients((rho_eps_g + core_d)[None], gc)[0]
                if plain:
                    sig = g[0] ** 2 + g[1] ** 2 + g[2] ** 2
                    e = self.xc.evaluate(rho, sig)["e"]
                else:
                    e = self.xc.evaluate_gga(rho, g)[0]
            else:
                e = self.xc.evaluate(rho)["e"]
        else:
            mag_r = to_r(mag_eps_g)
            tot = torch.clamp(rho_r + core_r, min=1e-25)
            m = torch.minimum(torch.maximum(mag_r, -tot), tot)
            n_up = ((tot + m) / 2).reshape(-1)
            n_dn = ((tot - m) / 2).reshape(-1)
            if self.xc.is_gga:
                tot_g = rho_eps_g + core_d
                g = self._gradients(torch.stack([0.5 * (tot_g + mag_eps_g),
                                                 0.5 * (tot_g - mag_eps_g)]),
                                    gc)
                gu, gd = g[0], g[1]
                if plain:
                    suu = gu[0] * gu[0] + gu[1] * gu[1] + gu[2] * gu[2]
                    sdd = gd[0] * gd[0] + gd[1] * gd[1] + gd[2] * gd[2]
                    sud = gu[0] * gd[0] + gu[1] * gd[1] + gu[2] * gd[2]
                    e = self.xc.evaluate_polarized(n_up, n_dn, suu, sud,
                                                   sdd)["e"]
                else:
                    e = self.xc.evaluate_gga_polarized(n_up, n_dn, gu, gd)[0]
            else:
                e = self.xc.evaluate_polarized(n_up, n_dn)["e"]
        return float(e.sum()) * om / n

    def _beta_k(self, ik, qlen, rlm, pref):
        """Strained beta-projector table for one k: the phase/prefactor
        convention pref * (-i)^l * R_lm * RI(q) * e^{-iG.r}."""
        ctx = self.ctx
        uc = ctx.unit_cell
        ngk = int(ctx.gkvec.num_gk[ik])
        beta_k = np.zeros((ctx.beta.num_beta_total, ngk), dtype=np.complex128)
        mk = ctx.gkvec.millers[ik, :ngk] + ctx.gkvec.kpoints[ik][None, :]
        for ia, off, nbf in ctx.beta.atom_blocks(uc):
            t = uc.atom_types[uc.type_of_atom[ia]]
            if not t.num_beta:
                continue
            ri = self.beta_tab[uc.type_of_atom[ia]](qlen[ik, :ngk])
            phase = np.exp(-2j * np.pi * (mk @ uc.positions[ia]))
            idxrf, ls, ms = t.beta_lm_table()
            for xi in range(nbf):
                l, m_, ir = int(ls[xi]), int(ms[xi]), int(idxrf[xi])
                beta_k[off + xi] = (
                    pref * (-1j) ** l * rlm[ik, :ngk, lm_index(l, m_)]
                    * ri[ir] * phase
                )
        return beta_k

    def e_nonloc(self, eps, psi, occ_w, evals, d_by_spin):
        """Non-local energy with strained projector tables; includes the
        -eps <psi|Q|psi> orthogonality term for ultrasoft. psi: the host
        copy of the bands."""
        ctx = self.ctx
        uc = ctx.unit_cell
        if ctx.beta.num_beta_total == 0:
            return 0.0
        gk = self._gkcart(eps)
        qlen = np.linalg.norm(gk, axis=-1)
        lmax = max(t.lmax_beta for t in uc.atom_types if t.num_beta)
        rhat = np.where(
            qlen[..., None] > 1e-30, gk / np.maximum(qlen, 1e-30)[..., None], np.array([0.0, 0, 1.0])
        )
        rlm = ylm_real(lmax, rhat)
        pref = 4.0 * np.pi / np.sqrt(self._omega(eps))
        qmat = ctx.beta.qmat
        e = 0.0
        nk = ctx.gkvec.num_kpoints
        for ik in range(nk):
            ngk = int(ctx.gkvec.num_gk[ik])
            beta_k = self._beta_k(ik, qlen, rlm, pref)
            for ispn in range(psi.shape[1]):
                ps = np.asarray(psi[ik, ispn])[:, :ngk]
                bp = np.conj(beta_k) @ ps.T  # (nbeta, nb)
                f = occ_w[ik, ispn]
                d = np.einsum("xb,xy,yb->b", np.conj(bp), d_by_spin[ispn], bp).real
                e += float(np.sum(f * d))
                if qmat is not None:
                    o = np.einsum("xb,xy,yb->b", np.conj(bp), qmat, bp).real
                    e -= float(np.sum(f * evals[ik, ispn] * o))
        return e

    # --- assembly -------------------------------------------------------
    def compute(self, rho_g, mag_g, psi, occ, evals, d_by_spin,
                dm_blocks_by_spin=None) -> dict:
        """Every stress term [3, 3] by name and their symmetrized sum
        ("total"). rho_g, mag_g: host arrays on the fine G set (mag_g None
        unpolarized); psi: the bands [nk, ns, nb, ngk], a tensor on any
        device or an array, copied to the host once; dm_blocks_by_spin:
        per-spin list of per-atom density-matrix blocks (required for the
        augmentation stress of ultrasoft species)."""
        ctx = self.ctx
        dev = self.device
        self.seconds = {}
        t0 = time.perf_counter()
        if isinstance(psi, torch.Tensor):
            psi = psi.cpu().numpy()
        occ = np.asarray(occ)
        evals = np.asarray(evals)
        self._refs = [np.asarray(rho_g),
                      None if mag_g is None else np.asarray(mag_g)]
        self._dm_comps = []
        self._density_eps_cache = {}
        if ctx.aug is not None and dm_blocks_by_spin:
            ns_dm = len(dm_blocks_by_spin)
            natoms = len(dm_blocks_by_spin[0])
            self._dm_comps = [[
                sum(dm_blocks_by_spin[s][ia] for s in range(ns_dm))
                for ia in range(natoms)
            ]]
            if mag_g is not None and ns_dm == 2:
                self._dm_comps.append([
                    dm_blocks_by_spin[0][ia] - dm_blocks_by_spin[1][ia]
                    for ia in range(natoms)
                ])
        if self.aug_dev is not None:
            # K4 builds the strained charge on the card: the references
            # and the density matrices go there once
            self._refs = [None if r is None else torch.as_tensor(r, device=dev)
                          for r in self._refs]
            if self._dm_comps:
                self._dm_dev = torch.as_tensor(
                    np.stack([dm_block_matrix(ctx, c) for c in self._dm_comps]),
                    device=dev)
        self._aug0 = (self._rho_aug_eps(np.zeros((3, 3)))
                      if self._dm_comps else [])
        self._aug0 += [0.0] * (2 - len(self._aug0))
        occ_w = occ * ctx.gkvec.weights[:, None, None]
        terms = {
            "har": lambda e: self.e_hartree(e),
            "vloc": lambda e: self.e_vloc(e),
            "ewald": lambda e: self.e_ewald(e),
            "xc": lambda e: self.e_xc(e),
            "nonloc": lambda e: self.e_nonloc(e, psi, occ_w, evals, d_by_spin),
        }
        self.seconds["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = {"kin": self.sigma_kinetic(psi, occ_w)}
        self.seconds["kin"] = time.perf_counter() - t0
        om = ctx.unit_cell.omega
        h = _H
        for name, fn in terms.items():
            t0 = time.perf_counter()
            s = np.zeros((3, 3))
            for a in range(3):
                for b in range(a, 3):
                    eps = np.zeros((3, 3))
                    eps[a, b] += h
                    eps[b, a] += h
                    de = (fn(eps) - fn(-eps)) / (2 * h)
                    # symmetric-strain derivative gives sigma_ab + sigma_ba
                    s[a, b] = s[b, a] = de / 2.0
            out[name] = s / om
            synchronize(dev)
            # the strained densities are built (and memoized) by the first
            # functional that asks, the Hartree term
            self.seconds[name] = time.perf_counter() - t0
        total = sum(out.values())
        out["total"] = symmetrize_stress(ctx, total)
        return out

    def sigma_kinetic(self, psi, occ_w) -> np.ndarray:
        """Closed-form kinetic stress (reference stress.cpp sigma_kin):
        under r -> (1+eps) r at frozen coefficients, gk -> (1+eps)^{-T} gk,
        so d(1/2 |gk|^2)/d eps_ab = -gk_a gk_b and

          sigma_kin_ab = -(1/Omega) sum_{k,s,b,G} w f |psi(G)|^2 gk_a gk_b

        psi: the host copy of the bands."""
        ctx = self.ctx
        s = np.zeros((3, 3))
        gk0 = np.asarray(ctx.gkvec.gkcart)
        for ik in range(ctx.gkvec.num_kpoints):
            dens = np.zeros(gk0.shape[1])
            for ispn in range(psi.shape[1]):
                dens += np.einsum(
                    "b,bg->g", occ_w[ik, ispn],
                    np.abs(np.asarray(psi[ik, ispn])) ** 2,
                )
            s -= np.einsum("g,ga,gb->ab", dens, gk0[ik], gk0[ik])
        return 0.5 * (s + s.T) / ctx.unit_cell.omega


def symmetrize_stress(ctx: SimulationContext, s: np.ndarray) -> np.ndarray:
    if ctx.symmetry is None or ctx.symmetry.num_ops <= 1:
        return 0.5 * (s + s.T)
    out = np.zeros((3, 3))
    for op in ctx.symmetry.ops:
        out += op.rot_cart @ s @ op.rot_cart.T
    out /= ctx.symmetry.num_ops
    return 0.5 * (out + out.T)
