"""Ultrasoft/PAW augmentation operator Q(G) and its contractions.

Reference: src/density/augmentation_operator.cpp (Q_{xi xi'}(G) tables),
Density::generate_rho_aug (density.cpp:1395, GPU kernels sum_q_pw_dm_pw.cu)
and Potential::generate_D_operator_matrix (generate_d_operator_matrix.cpp:26).

Conventions (validated against the reference):
  Q_{xi1 xi2}(G) = (4 pi / Omega) sum_{lm3} (-i)^{l3} R_{lm3}(^G)
                   <R_{lm1} R_{lm2} R_{lm3}>  RI_aug(rf12, l3, |G|)
  RI_aug(rf12, l3, q) = int j_{l3}(q r) Q^{l3}_{rf1 rf2}(r) dr
                        (species files store Q(r) including the r^2 factor)
  q_mtrx = Omega * Q(G=0)            (augmentation_operator.cpp:100-110)
  rho_aug(G) = sum_a sum_{xi1 xi2} n^a_{xi1 xi2} Q_{xi1 xi2}(G) e^{-i G r_a}
  D^a_{xi1 xi2} = d_ion + Omega * sum_G conj(V_eff(G)) Q_{xi1 xi2}(G) e^{-i G r_a}
  n^a_{xi1 xi2} = sum_{k,s,b} w_k f conj(<beta_xi1|psi>) <beta_xi2|psi>

Only the packed upper triangle of (xi1 <= xi2) is stored, mirroring the
reference's nqlm = nbf(nbf+1)/2 layout.

Mirrors sirius_tpu/ops/augmentation.py: the host tables (:35-124) by copy,
and the device contractions rho_aug_g_device / d_operator_device
(:212-282) through kernels K4 and K5 (kernels/augmentation.py), which
generate the atomic phases on the fly instead of storing them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.core.gvec import Gvec
from sirius_tpu_torch.core.radial import RadialIntegralTable
from sirius_tpu_torch.core.sht import gaunt_rlm, lm_index, num_lm, ylm_real
from sirius_tpu_torch.crystal.unit_cell import UnitCell
from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.kernels.augmentation import d_operator, rho_aug


@dataclasses.dataclass
class AugmentationType:
    """Per-species augmentation tables."""

    q_pw: np.ndarray  # (nqlm, ng) complex: Q_{packed}(G), no atom phase
    xi1: np.ndarray  # (nqlm,) unpacked pair indices
    xi2: np.ndarray
    q_mtrx: np.ndarray  # (nbf, nbf) = Omega * Q(0)


@dataclasses.dataclass
class Augmentation:
    per_type: list[AugmentationType | None]

    @staticmethod
    def build(uc: UnitCell, gvec: Gvec) -> "Augmentation":
        out = []
        for t in uc.atom_types:
            out.append(_build_type(t, gvec, uc.omega) if t.augmentation else None)
        return Augmentation(per_type=out)


def aug_radial_tables(t, qmax: float) -> list:
    """Per-l3 spline tables of RI_aug(packed rf12, l3, q), evaluable at
    arbitrary q <= qmax (used for shells here; for strained |G| in the
    stress calculator)."""
    lmax3 = 2 * t.lmax_beta
    nbrf = t.num_beta
    nrf12 = nbrf * (nbrf + 1) // 2
    qfuncs = np.zeros((nrf12, lmax3 + 1, len(t.r)))
    for ch in t.augmentation:
        i, j = min(ch.i, ch.j), max(ch.i, ch.j)
        idx = j * (j + 1) // 2 + i
        qfuncs[idx, ch.l, : len(ch.qr)] = ch.qr
    return [
        RadialIntegralTable.build(
            t.r, qfuncs[:, l3, :], np.full(nrf12, l3), qmax=qmax, m=0
        )
        for l3 in range(lmax3 + 1)
    ]


def _build_type(t, gvec: Gvec, omega: float) -> AugmentationType:
    nbf = t.num_beta_lm
    qshell = np.sqrt(gvec.shell_g2)
    tabs = aug_radial_tables(t, qmax=qshell[-1] + 1e-9)
    q_pw = q_pw_at(t, tabs, gvec.gcart, omega)
    nqlm = nbf * (nbf + 1) // 2
    xi1 = np.zeros(nqlm, dtype=np.int32)
    xi2 = np.zeros(nqlm, dtype=np.int32)
    for b in range(nbf):
        for a in range(b + 1):
            xi1[b * (b + 1) // 2 + a] = a
            xi2[b * (b + 1) // 2 + a] = b
    q0 = q_pw[:, 0].real * omega
    q_mtrx = np.zeros((nbf, nbf))
    q_mtrx[xi2, xi1] = q0
    q_mtrx[xi1, xi2] = q0
    return AugmentationType(q_pw=q_pw, xi1=xi1, xi2=xi2, q_mtrx=q_mtrx)


def q_pw_at(t, tabs, gcart: np.ndarray, omega: float) -> np.ndarray:
    """Q_{packed}(G) for arbitrary Cartesian G vectors (no atom phase):
    the _build_type formula with the radial tables evaluated at |G| and the
    real harmonics at ^G — the strained-lattice evaluation path of the
    stress calculator (reference sigma_us uses d/dq tables instead,
    stress.cpp)."""
    lb = t.lmax_beta
    lmax3 = 2 * lb
    nbf = t.num_beta_lm
    idxrf, ls, ms = t.beta_lm_table()
    glen = np.linalg.norm(gcart, axis=1)
    rhat = np.where(
        glen[:, None] > 1e-30,
        gcart / np.maximum(glen, 1e-30)[:, None],
        np.array([0.0, 0, 1.0]),
    )
    rlm3 = ylm_real(lmax3, rhat)
    gaunt = gaunt_rlm(lb, lb, lmax3)
    mi_l3 = np.asarray([(-1j) ** l for l in range(lmax3 + 1)])
    l_of_lm3 = np.asarray([int(np.sqrt(lm)) for lm in range(num_lm(lmax3))])
    ri = np.stack([tabs[l3](glen) for l3 in range(lmax3 + 1)], axis=1)
    nqlm = nbf * (nbf + 1) // 2
    q_pw = np.zeros((nqlm, len(glen)), dtype=np.complex128)
    pref = 4.0 * np.pi / omega
    for b in range(nbf):
        for a in range(b + 1):
            idx12 = b * (b + 1) // 2 + a
            ra, rb = int(idxrf[a]), int(idxrf[b])
            rf12 = max(ra, rb) * (max(ra, rb) + 1) // 2 + min(ra, rb)
            lm_a = lm_index(int(ls[a]), int(ms[a]))
            lm_b = lm_index(int(ls[b]), int(ms[b]))
            acc = np.zeros(len(glen), dtype=np.complex128)
            for lm3 in np.nonzero(np.abs(gaunt[lm_a, lm_b]) > 1e-14)[0]:
                l3 = l_of_lm3[lm3]
                acc += (
                    mi_l3[l3]
                    * gaunt[lm_a, lm_b, lm3]
                    * rlm3[:, lm3]
                    * ri[rf12, l3, :]
                )
            q_pw[idx12] = pref * acc
    return q_pw


# ---------------------------------------------------------------------------
# Device-resident augmentation: the per-type tables on the device, the
# contractions through K4 (rho_aug) and K5 (d_operator).
# ---------------------------------------------------------------------------


def build_aug_device_tables(uc: UnitCell, gvec: Gvec, aug: Augmentation,
                            beta, device=None) -> list[dict]:
    """Per-type tensors for rho_aug_g_device / d_operator_device.

    Each entry holds the Millers [ng, 3] int32 (one tensor shared by the
    types), the type's fractional positions [na, 3], q_pw [nqlm, ng]
    complex128, the packed-pair weights w, and gidx / lo_idx / lo_mask:
    gidx flattens the (off + xi1, off + xi2) positions of each atom's packed
    pairs into the [nbeta * nbeta] D matrix (the upper/packed site); lo_idx
    is the mirrored (off + xi2, off + xi1) site with lo_mask zeroing the
    diagonal pairs — together they reproduce the host d_operator's
    symmetric block fill without double-counting xi1 == xi2. No phase table:
    the kernels generate e^{-2 pi i G . tau} from the Millers."""
    device = resolve_device(device)
    nbeta = beta.num_beta_total
    offs = {ia: off for ia, off, _ in beta.atom_blocks(uc)}
    millers = torch.as_tensor(np.asarray(gvec.millers, dtype=np.int32),
                              device=device)
    out = []
    for it, at in enumerate(aug.per_type):
        if at is None:
            continue
        atoms = uc.atoms_of_type(it)
        gidx = np.stack([
            (offs[ia] + at.xi1).astype(np.int64) * nbeta + (offs[ia] + at.xi2)
            for ia in atoms
        ])  # (na_t, nqlm)
        lo_idx = np.stack([
            (offs[ia] + at.xi2).astype(np.int64) * nbeta + (offs[ia] + at.xi1)
            for ia in atoms
        ])
        # the kernels trust these indices: check them against D once
        if min(gidx.min(), lo_idx.min()) < 0 or \
                max(gidx.max(), lo_idx.max()) >= nbeta * nbeta:
            raise ValueError("augmentation pair index outside D")

        def t(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        out.append({
            "millers": millers,
            "pos": t(uc.positions[atoms], torch.float64),
            "q": t(at.q_pw, torch.complex128),
            "w": t(np.where(at.xi1 == at.xi2, 1.0, 2.0), torch.float64),
            "gidx": t(gidx, torch.int32),
            "lo_idx": t(lo_idx, torch.int32),
            "lo_mask": t((at.xi1 != at.xi2).astype(np.float64), torch.float64),
        })
    return out


def rho_aug_g_device(dm: torch.Tensor, tables: list[dict],
                     ng: int) -> torch.Tensor:
    """rho_aug_g over all spin channels at once: dm complex128
    [ns, nbeta, nbeta] (full matrix), returns [ns, ng] complex128; the types
    are summed in order (K4)."""
    out = None
    for t in tables:
        out = rho_aug(dm, t["gidx"], t["w"], t["millers"], t["pos"], t["q"],
                      out=out)
    if out is None:
        out = torch.zeros((dm.shape[0], ng), dtype=torch.complex128,
                          device=dm.device)
    return out


def d_operator_device(veff_g: torch.Tensor, dion: torch.Tensor,
                      tables: list[dict], omega: float) -> torch.Tensor:
    """d_operator for one effective-potential channel: veff_g complex128
    [ng], dion float64 [nbeta, nbeta] bare matrix; returns the full real D
    [nbeta, nbeta] (K5, one launch per type)."""
    d = dion.clone()
    for t in tables:
        d_operator(veff_g, t["millers"], t["pos"], t["q"], t["gidx"],
                   t["lo_idx"], t["lo_mask"], omega, d)
    return d
