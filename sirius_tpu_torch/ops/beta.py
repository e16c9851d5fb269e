"""Beta projectors and non-local D/Q operators.

Reference: src/beta_projectors/ (chunked per atoms, generated on the fly with
create_beta_gk.cu) and src/hamiltonian/non_local_operator.hpp (D/Q packed
per-atom matrices, applied chunk by chunk via SPLA GEMMs).

Design: projectors for the whole cell and every k-point are precomputed
once per geometry as one dense table beta[nk, nbeta_tot, ngk_max] (complex)
and the application is two einsums — <beta|psi> then beta . (D <beta|psi>) —
which map straight onto batched matrix products. Chunking exists in the reference to bound
memory; here nbeta_tot is bounded (tens per atom) and the table is the same
order of size as the wave functions themselves.

Conventions (matching the reference):
  beta_t,xi(G+k) = (-i)^l (4 pi / sqrt(Omega)) R_lm(^G+k) RI_xi(|G+k|)
  RI_xi(q) = int j_l(q r) [r beta(r)] r dr      (file stores r*beta)
  beta_a = beta_t e^{-i(G+k).r_a}               (beta_projectors_base.cpp:60-76)
  D applied as: H psi += sum_aa' beta_a D^a_{xi xi'} <beta_a'|psi>
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sirius_tpu_torch.core.gvec import GkVec
from sirius_tpu_torch.core.radial import RadialIntegralTable
from sirius_tpu_torch.core.sht import lm_index, num_lm, ylm_real
from sirius_tpu_torch.crystal.unit_cell import UnitCell


def beta_radial_table(t, qmax: float) -> RadialIntegralTable | None:
    """RI_xi(q) = int j_l(q r) [r beta(r)] r dr table for one species
    (single source for projector radial conventions)."""
    if not t.num_beta:
        return None
    funcs = np.zeros((t.num_beta, len(t.r)))
    for i, b in enumerate(t.beta):
        funcs[i, : b.nr] = b.rbeta
    return RadialIntegralTable.build(
        t.r, funcs, np.array([b.l for b in t.beta]), qmax, m=1
    )


@dataclasses.dataclass
class BetaProjectors:
    """Dense per-k beta-projector tables + packed D/Q matrices.

    Arrays (numpy, uploaded by the Hamiltonian):
      beta_gk: (nk, nbeta_tot, ngk_max) complex  — <G+k|beta_xi^a>
      dion:    (nbeta_tot, nbeta_tot)            — bare D (from D_ion)
      qmat:    (nbeta_tot, nbeta_tot) or None    — <Q_ij> integrals (US/PAW)
      atom_of_beta, l_of_beta: (nbeta_tot,)
    nbeta_tot = sum over atoms of per-type (2l+1)-expanded projector counts.
    """

    beta_gk: np.ndarray
    dion: np.ndarray
    qmat: np.ndarray | None
    atom_of_beta: np.ndarray
    l_of_beta: np.ndarray
    offsets: np.ndarray  # (natom,) start of each atom's projector block

    @property
    def num_beta_total(self) -> int:
        return self.beta_gk.shape[1]

    def atom_blocks(self, uc: UnitCell):
        """Yield (ia, start, nbf) for each atom's projector block — the
        single source of truth for the packed projector layout."""
        for ia in range(uc.num_atoms):
            nbf = uc.atom_types[uc.type_of_atom[ia]].num_beta_lm
            yield ia, int(self.offsets[ia]), nbf

    @staticmethod
    def build(uc: UnitCell, gkvec: GkVec, qmax: float) -> "BetaProjectors":
        nk, ngk = gkvec.num_kpoints, gkvec.ngk_max
        lmax = max((t.lmax_beta for t in uc.atom_types), default=-1)
        # per-type radial integral tables RI(idxrf, q)
        tables = [beta_radial_table(t, qmax) for t in uc.atom_types]
        # count total projectors (lm-expanded) over atoms
        counts = [uc.atom_types[it].num_beta_lm for it in uc.type_of_atom]
        nbeta_tot = int(np.sum(counts))
        beta_gk = np.zeros((nk, nbeta_tot, ngk), dtype=np.complex128)
        atom_of_beta = np.zeros(nbeta_tot, dtype=np.int32)
        l_of_beta = np.zeros(nbeta_tot, dtype=np.int32)
        dion = np.zeros((nbeta_tot, nbeta_tot))
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)

        if nbeta_tot and lmax >= 0:
            gk = gkvec.gkcart  # (nk, ngk, 3)
            qlen = np.linalg.norm(gk, axis=-1)
            rhat = gk / np.maximum(qlen, 1e-30)[..., None]
            rhat = np.where(qlen[..., None] > 1e-30, rhat, np.array([0.0, 0, 1.0]))
            rlm = ylm_real(lmax, rhat)  # (nk, ngk, nlm)
            minus_i_pow = [(-1j) ** l for l in range(lmax + 1)]
            pref = 4.0 * np.pi / np.sqrt(uc.omega)

            off = 0
            for ia in range(uc.num_atoms):
                it = uc.type_of_atom[ia]
                t = uc.atom_types[it]
                if not t.num_beta:
                    continue
                ri = tables[it](qlen.reshape(-1)).reshape(t.num_beta, nk, ngk)
                # phase e^{-i(G+k).r_a}: (G+k).r_a = 2 pi (m + k) . x_a
                mk = gkvec.millers + gkvec.kpoints[:, None, :]
                phase = np.exp(-2j * np.pi * (mk @ uc.positions[ia]))  # (nk, ngk)
                idxrf, ls, ms = t.beta_lm_table()
                for xi in range(t.num_beta_lm):
                    l, m, ir = int(ls[xi]), int(ms[xi]), int(idxrf[xi])
                    beta_gk[:, off + xi, :] = (
                        pref
                        * minus_i_pow[l]
                        * rlm[..., lm_index(l, m)]
                        * ri[ir]
                        * phase
                        * gkvec.mask
                    )
                    atom_of_beta[off + xi] = ia
                    l_of_beta[off + xi] = l
                # D_ion expansion: D_{xi xi'} = D_ion[ir, ir'] delta_{l l'} delta_{m m'}
                sel = (ls[:, None] == ls[None, :]) & (ms[:, None] == ms[None, :])
                dion[off : off + t.num_beta_lm, off : off + t.num_beta_lm] = np.where(
                    sel, t.d_ion[np.ix_(idxrf, idxrf)], 0.0
                )
                off += t.num_beta_lm
        # qmat (S-operator integrals) is assembled by the SimulationContext
        # from the Augmentation tables: q_mtrx = Omega * Q(G=0) exactly.
        return BetaProjectors(
            beta_gk=beta_gk,
            dion=dion,
            qmat=None,
            atom_of_beta=atom_of_beta,
            l_of_beta=l_of_beta,
            offsets=offsets,
        )
