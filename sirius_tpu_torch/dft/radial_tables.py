"""G-space form factors from species radial data, and periodic-function
assembly (reference: src/radial/radial_integrals.cpp + make_periodic_function.hpp).

All tables are built host-side once per geometry on the G-shell values (the
G-set is |G|-sorted with shells precomputed, so each unique |G| is evaluated
once and scattered to the full G array), then are uploaded to the device once.

Form-factor conventions (matching the reference exactly):
  vloc:     ff(q)  = (1/q) int_0^rc [r V(r) + z erf(r)] sin(q r) dr
                     - z e^{-q^2/4} / q^2
            ff(0)  = int [r V(r) + z] r dr
            (radial_integrals.cpp:240-305; integration truncated at
             settings.pseudo_grid_cutoff = 10 a.u., the QE tail hack)
  rho_core: ff(q)  = int j_0(q r) rho_core(r) r^2 dr
  rho_total:ff(q)  = int j_0(q r) rho_ps(r) dr / (4 pi)
            (file stores 4 pi r^2 rho)
  field:    f(G)   = (4 pi / Omega) sum_t ff_t(|G|) conj(S_t(G))
            S_t(G) = sum_{a in t} e^{i 2 pi G_miller . x_a}
"""

from __future__ import annotations

import numpy as np

from sirius_tpu_torch.core.gvec import Gvec
from sirius_tpu_torch.core.radial import Spline, spline_quadrature_weights
from sirius_tpu_torch.crystal.unit_cell import UnitCell

# default of reference settings.pseudo_grid_cutoff (the "QE tail hack");
# NOTE some reference verification outputs were generated with 8.0 — the
# deck harness replays the value recorded in output_ref.json's resolved
# config (tools/run_decks.py), the 1e-5-class energy sensitivity is real
PSEUDO_GRID_CUTOFF = 10.0


def _truncate(r: np.ndarray, rc: float) -> int:
    """Reference-equivalent point count: radial_grid().index_of(rc) is the
    last index with r <= rc and segment(np) keeps indices [0, np), so the
    kept range STOPS one point short of that index. The truncated vloc
    integrand does not decay (the QE tail hack exists precisely because of
    that), so a one-point difference is a ~3e-5 Ha energy shift (SrVO3).
    When rc lies outside the grid, index_of returns -1 and the reference
    keeps the FULL grid (radial_integrals.cpp:264)."""
    if rc > r[-1] or rc < r[0]:
        return len(r)
    n = int(np.searchsorted(r, rc, side="right")) - 1
    return max(n, 2)


def vloc_ff(rc: float):
    """Form-factor closure with a bound pseudo_grid_cutoff — the shared
    wrapper for every consumer that threads the config value through."""
    return lambda t, q: vloc_form_factor(t, q, rc=rc)


def vloc_form_factor(atype, q: np.ndarray, rc: float | None = None) -> np.ndarray:
    """Local-potential form factor at |G| values q (may include 0).
    rc: integration cutoff (settings.pseudo_grid_cutoff)."""
    from scipy.special import erf

    np_cut = _truncate(atype.r, PSEUDO_GRID_CUTOFF if rc is None else rc)
    r = atype.r[:np_cut]
    v = atype.vloc[:np_cut]
    w = spline_quadrature_weights(r)
    base = r * v + atype.zn * erf(r)
    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    out = np.empty(len(q))
    for i, qi in enumerate(q):
        if qi < 1e-12:
            out[i] = float(np.sum(w * (r * v + atype.zn) * r))
        else:
            out[i] = float(np.sum(w * base * np.sin(qi * r))) / qi - atype.zn * np.exp(
                -qi * qi / 4.0
            ) / (qi * qi)
    return out


def rho_core_form_factor(atype, q: np.ndarray) -> np.ndarray:
    from sirius_tpu_torch.core.radial import sbessel_integral

    if atype.rho_core is None:
        return np.zeros(len(np.atleast_1d(q)))
    return sbessel_integral(atype.r, atype.rho_core, 0, q, m=2)


def rho_total_form_factor(atype, q: np.ndarray) -> np.ndarray:
    """Free-atom valence density form factor; file stores 4 pi r^2 rho."""
    from sirius_tpu_torch.core.radial import sbessel_integral

    if atype.rho_total is None:
        return np.zeros(len(np.atleast_1d(q)))
    return sbessel_integral(atype.r, atype.rho_total, 0, q, m=0) / (4.0 * np.pi)


def structure_factors(uc: UnitCell, gvec: Gvec) -> np.ndarray:
    """S_t(G) = sum_{a in t} e^{2 pi i m . x_a}, shape (ntypes, ng)."""
    out = np.zeros((len(uc.atom_types), gvec.num_gvec), dtype=np.complex128)
    phase = np.exp(2j * np.pi * (gvec.millers @ uc.positions.T))  # (ng, natom)
    for it in range(len(uc.atom_types)):
        sel = uc.type_of_atom == it
        out[it] = phase[:, sel].sum(axis=1)
    return out


def make_periodic_function(
    uc: UnitCell, gvec: Gvec, form_factor_fn, sfact: np.ndarray | None = None,
) -> np.ndarray:
    """f(G) = (4 pi / Omega) sum_t ff_t(|G|) conj(S_t(G)), evaluated on
    shells then scattered to the full G array. (The JAX package's host
    radial-integral callbacks of the C API come with the capi.py port.)"""
    if sfact is None:
        sfact = structure_factors(uc, gvec)
    qshell = np.sqrt(gvec.shell_g2)
    f = np.zeros(gvec.num_gvec, dtype=np.complex128)
    for it, at in enumerate(uc.atom_types):
        ff_shell = np.asarray(form_factor_fn(at, qshell))
        f += ff_shell[gvec.shell_idx] * np.conj(sfact[it])
    return f * (4.0 * np.pi / uc.omega)
