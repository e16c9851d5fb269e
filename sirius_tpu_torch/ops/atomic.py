"""Atomic-orbital PW coefficients for the LCAO initial subspace
(reference: initialize_subspace.hpp:27 per-k LCAO guess, built from
Radial_integrals_atomic_wf). Same construction as beta projectors:
phi_lm(G+k) = (-i)^l (4 pi / sqrt(Omega)) R_lm(^G+k) RI(|G+k|) e^{-i(G+k).r_a}
with RI(q) = int j_l(q r) chi(r) r dr (files store chi = r*phi)."""

from __future__ import annotations

import numpy as np

from sirius_tpu_torch.core.gvec import GkVec
from sirius_tpu_torch.core.radial import RadialIntegralTable
from sirius_tpu_torch.core.sht import lm_index, ylm_real
from sirius_tpu_torch.crystal.unit_cell import UnitCell


def atomic_orbitals(uc: UnitCell, gkvec: GkVec, qmax: float) -> np.ndarray:
    """Returns (nk, nao_tot, ngk_max) complex orbitals, or (nk, 0, ngk)."""
    nk, ngk = gkvec.num_kpoints, gkvec.ngk_max
    lmax = max((max((w.l for w in t.atomic_wfs), default=-1) for t in uc.atom_types), default=-1)
    nao = sum(uc.atom_types[it].num_atomic_wf_lm for it in uc.type_of_atom)
    out = np.zeros((nk, nao, ngk), dtype=np.complex128)
    if nao == 0 or lmax < 0:
        return out
    tables = []
    for t in uc.atom_types:
        if t.atomic_wfs:
            funcs = np.stack([w.chi for w in t.atomic_wfs])
            tables.append(
                RadialIntegralTable.build(
                    t.r, funcs, np.array([w.l for w in t.atomic_wfs]), qmax, m=1
                )
            )
        else:
            tables.append(None)
    gk = gkvec.gkcart
    qlen = np.linalg.norm(gk, axis=-1)
    rhat = np.where(
        qlen[..., None] > 1e-30, gk / np.maximum(qlen, 1e-30)[..., None], np.array([0.0, 0, 1.0])
    )
    rlm = ylm_real(lmax, rhat)
    pref = 4.0 * np.pi / np.sqrt(uc.omega)
    off = 0
    for ia in range(uc.num_atoms):
        t = uc.atom_types[uc.type_of_atom[ia]]
        if not t.atomic_wfs:
            continue
        ri = tables[uc.type_of_atom[ia]](qlen.reshape(-1)).reshape(len(t.atomic_wfs), nk, ngk)
        mk = gkvec.millers + gkvec.kpoints[:, None, :]
        phase = np.exp(-2j * np.pi * (mk @ uc.positions[ia]))
        xi = 0
        for iw, w in enumerate(t.atomic_wfs):
            for m in range(-w.l, w.l + 1):
                out[:, off + xi, :] = (
                    pref
                    * (-1j) ** w.l
                    * rlm[..., lm_index(w.l, m)]
                    * ri[iw]
                    * phase
                    * gkvec.mask
                )
                xi += 1
        off += t.num_atomic_wf_lm
    return out
