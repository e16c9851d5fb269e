"""The fused SCF step: density -> mixer -> potential -> D / h_diag refresh
on the device, with one scalar record an iteration read back.

Mirrors sirius_tpu/dft/fused.py::FusedScf. The JAX package compiles the
post-band-solve half of an iteration into one jitted program over a
donated carry and fetches a [NUM_SCALARS] vector of convergence and energy
scalars; here the same half runs eagerly, its carry (the mixed vector, the
mixer's history ring, the potential and B_z the next Harris term reads)
lives in device tensors updated in place, and every scalar the loop needs
is reduced into one record (K15) that `read_record` fetches once. Nothing
in `step` reads the device: the mixer's history count is a host integer
(dft/mixer.py::DeviceMixer), the m x m solve runs on the card (K14b), and
the energy integrals stay device tensors until K15 reduces them.

run_scf (dft/scf.py) takes this path where the JAX package does on one
device (dft/scf.py::fuses): the k-set band solve, no mGGA, a linear or
Anderson (broyden1) mixer and control.device_scf not off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sirius_tpu_torch.dft.density import (
    density_from_coarse_acc,
    symmetrize_density_matrix_device,
    symmetrize_pw,
)
from sirius_tpu_torch.dft.mixer import DeviceMixer
from sirius_tpu_torch.dft.potential import generate_potential
from sirius_tpu_torch.kernels.scf_record import Segment, scf_record
from sirius_tpu_torch.ops.augmentation import (
    d_operator_device,
    rho_aug_g_device,
)
from sirius_tpu_torch.parallel.batched import compute_h_diag

# indices into the per-iteration scalar record (sirius_tpu/dft/fused.py:65-89)
S_RMS = 0  # mixer rms (pre-mix)
S_EHA = 1  # Hartree energy of the (mixed - new) charge residual
S_VHA = 2  # int rho v_ha
S_VXC = 3  # int rho v_xc
S_VLOC = 4  # int rho v_loc
S_VEFF = 5  # int rho v_eff
S_EXC = 6  # int (rho + rho_core) eps_xc
S_BXC = 7  # int m b_xc
S_E1 = 8  # E_pot[rho_out] under the OLD potential
S_E2 = 9  # E_pot[rho_out] under the NEW potential
S_EVAL = 10  # sum_k w_k occ eps
S_NEL = 11  # electron count from rho_out (before symmetrization)
S_MAG = 12  # total moment from m_out (pre-mix)
S_V0 = 13  # Re veff(G=0)
S_ENT = 14  # smearing entropy sum
S_FINITE = 15  # 1.0 when the mixed vector, new potential and evals are finite
S_ORTHO = 16  # max |psi^H S psi - I|
S_CHG = 17  # |Re x_mixed[0] - Re x_new[0]| * omega
S_SYM = 18  # max |P_sym rho_new - rho_new|
S_HERM = 19  # max |H_nl - H_nl^H|
NUM_SCALARS = 20
# the potential's integrals and their slots
ENERGY_SLOTS = {"vha": S_VHA, "vxc": S_VXC, "vloc": S_VLOC, "veff": S_VEFF,
                "exc": S_EXC, "bxc": S_BXC}


def read_record(record: torch.Tensor) -> list:
    """The one device -> host read of a fused iteration: the record as
    python floats. Counts its calls (read_record.calls)."""
    read_record.calls += 1
    return record.tolist()


read_record.calls = 0


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1)


def _real0(z: torch.Tensor) -> torch.Tensor:
    """Re z[0] as a one-element float64 tensor (a view)."""
    return torch.view_as_real(z)[:1, 0]


@dataclasses.dataclass
class StepOut:
    """What one fused step hands back to the loop, all on the device."""
    record: torch.Tensor  # [NUM_SCALARS] float64
    pot: object  # PotentialResult of the mixed density
    d_spin: torch.Tensor  # [ns, nbeta, nbeta] float64 D of pot
    h_diag: torch.Tensor  # [nk, ns, ngk] preconditioner diagonal of pot
    dm: torch.Tensor | None  # [ns, nbeta, nbeta] symmetrized density matrix
    resid: torch.Tensor  # [ng] rho_out - rho_in (the scf_corr force)


class FusedScf:
    """One deck's fused step. The tables come from run_scf, built once:
    the grid tables (potential, coarse index, coarse-to-fine map, K6
    tables), the augmentation tables and the density-matrix symmetry, the
    k-set's projectors, kinetic energies and mask; the mixer weights are
    the host Mixer's."""

    def __init__(self, ctx, xc, mixer, polarized: bool, tables, aug_tables,
                 dm_sym, beta, ekin, gmask):
        self.ctx = ctx
        self.xc = xc
        self.polarized = bool(polarized)
        self.ns = 2 if polarized else 1
        self.ng = ctx.gvec.num_gvec
        self.omega = float(ctx.unit_cell.omega)
        self.nx = self.ns * self.ng
        self.tables = tables
        self.aug_tables = aug_tables
        self.dm_sym = dm_sym
        self.mixer = DeviceMixer(mixer, self.nx)
        dev = tables.glen2.device
        nbeta = ctx.beta.num_beta_total
        self.dion = torch.as_tensor(np.real(np.asarray(ctx.beta.dion)),
                                    dtype=torch.float64, device=dev)
        # the bare augmentation overlap Q: the S metric of the ledger's
        # orthonormality invariant
        qmat = (np.real(np.asarray(ctx.beta.qmat))
                if nbeta and ctx.beta.qmat is not None
                else np.zeros((nbeta, nbeta)))
        self.qmat = torch.as_tensor(qmat, dtype=torch.complex128, device=dev)
        self.beta = beta  # [nk, nbeta, ngk] complex128, zero on padded lanes
        self.ekin = ekin
        self.gmask = gmask
        self.x = self.veff = self.bz = None

    # -- host <-> device edges -------------------------------------------

    def init_carry(self, x_mix: torch.Tensor, pot, history: dict | None = None):
        """Seed the carry from a mixed vector and its potential, with an
        empty mixer history, or the one `history` holds ({'mix_x': [m,
        nx], 'mix_f': [m, nx]}, oldest first): the start of a run, a
        resume from a checkpoint and a rollback of dft/recovery.py."""
        self.x = x_mix.clone()
        self.veff = pot.veff_g.clone()
        self.bz = (pot.bz_g.clone() if self.polarized
                   else torch.zeros_like(pot.veff_g))
        if history and "mix_x" in history:
            self.mixer.load_history(history["mix_x"], history["mix_f"])
        else:
            self.mixer.flush()

    def fetch_state(self, with_history: bool = False):
        """Host copy of the mixed vector (and the mixer history, oldest
        first): an explicit transfer outside the step, and a copy on the
        CPU too (the carry is updated in place, a snapshot must not be)."""
        def host(t):
            return t.to("cpu", copy=True).numpy()

        x = host(self.x)
        if not with_history:
            return x, None
        hist = {}
        if self.mixer.count:
            hx, hf = self.mixer.history()
            hist = {"mix_x": host(hx), "mix_f": host(hf)}
        return x, hist

    def finalize(self, out: StepOut) -> dict:
        """What the report, the forces and the stress read after the loop:
        the mixed density, the final D, the density matrix and the density
        residual (device tensors)."""
        return {
            "rho_g": self.x[:self.ng],
            "mag_g": self.x[self.ng:] if self.polarized else None,
            "d_spin": out.d_spin,
            "dm": out.dm,
            "rho_resid": out.resid,
        }

    # -- the step --------------------------------------------------------

    def step(self, acc, dm, ev, occ_w, ent, psi) -> StepOut:
        """One fused iteration after the band solve and K13. acc: [ns,
        coarse box] occupation-weighted |psi(r)|^2 (density_kset); dm:
        [ns, nbeta, nbeta] density matrix (None for norm-conserving); ev,
        occ_w: [nk, ns, nb] float64 evals and occ * kweights; ent: the
        entropy sum (0-d); psi: [nk, ns, nb, ngk] bands for the ledger."""
        ctx, tb, ng, om = self.ctx, self.tables, self.ng, self.omega
        rho_spin = density_from_coarse_acc(ctx, acc, tb)
        if self.aug_tables is not None:
            if self.dm_sym is not None:
                dm = symmetrize_density_matrix_device(dm, self.dm_sym)
            rho_spin = rho_spin + rho_aug_g_device(dm.contiguous(),
                                                   self.aug_tables, ng)
        rho_raw = rho_spin.sum(dim=0)
        mag_new = rho_spin[0] - rho_spin[1] if self.polarized else None
        rho_new = rho_raw
        if tb.sym is not None:
            rho_new = symmetrize_pw(tb.sym, rho_raw)
            if self.polarized:
                mag_new = symmetrize_pw(tb.sym, mag_new, axial_z=True)
        x_new = torch.cat([rho_new, mag_new]) if self.polarized else rho_new

        # mixing (rms before the mix, eha after it), then the potential of
        # the mixed density
        x_in = self.x
        x_mixed, rms, eha = self.mixer.mix(x_in, x_new)
        resid = rho_new - x_in[:ng]
        pot = generate_potential(ctx, x_mixed[:ng], self.xc, tb,
                                 x_mixed[ng:] if self.polarized else None)
        veff_new, bz_new = pot.veff_g, pot.bz_g
        v0 = veff_new[0].real

        # the next band solve's D (K5, every spin channel in one launch)
        # and preconditioner diagonal
        if self.aug_tables is not None:
            v_spin = (torch.stack([veff_new + bz_new, veff_new - bz_new])
                      if self.polarized else veff_new[None])
            d_spin = d_operator_device(v_spin, self.dion, self.aug_tables, om)
        else:
            d_spin = self.dion.expand(self.ns, -1, -1)
        h_diag = compute_h_diag(self.ekin, self.gmask, self.beta,
                                d_spin.to(torch.complex128).contiguous(), v0)

        # the numerics ledger's products (plain matrix products, as the JAX
        # package leaves them to XLA) with the BARE D and Q
        psi_c = psi.to(torch.complex128) * self.gmask[:, None, None, :]
        bp = torch.einsum("kxg,ksbg->ksbx", self.beta.conj(), psi_c)
        gram = torch.einsum("ksbg,kscg->ksbc", psi_c.conj(), psi_c)
        gram = gram + torch.einsum("ksbx,xy,kscy->ksbc", bp.conj(),
                                   self.qmat, bp)
        h_nl = torch.einsum("ksbx,xy,kscy->ksbc", bp.conj(),
                            self.dion.to(torch.complex128), bp)
        nb = psi_c.shape[2]

        box = om / float(np.prod(tb.dims))
        segs = [Segment("sum", S_RMS, rms.reshape(1)),
                Segment("sum", S_EHA, eha.reshape(1))]
        for name, slot in ENERGY_SLOTS.items():
            segs += [Segment("dot", slot, _flat(f), _flat(g), scale=box)
                     for f, g in pot.integrands[name]]
        segs += [Segment("dot_c", S_E1, rho_new, self.veff, scale=om),
                 Segment("dot_c", S_E2, rho_new, veff_new, scale=om)]
        if self.polarized:
            segs += [Segment("dot_c", S_E1, mag_new, self.bz, scale=om),
                     Segment("dot_c", S_E2, mag_new, bz_new, scale=om),
                     Segment("sum", S_MAG, _real0(mag_new), scale=om)]
        segs += [
            Segment("dot", S_EVAL, _flat(occ_w), _flat(ev)),
            Segment("sum", S_NEL, _real0(rho_raw), scale=om),
            Segment("sum", S_V0, _real0(veff_new)),
            Segment("sum", S_ENT, ent.reshape(1)),
            Segment("finite", S_FINITE, _flat(torch.view_as_real(x_mixed))),
            Segment("finite", S_FINITE, _flat(torch.view_as_real(veff_new))),
            Segment("finite", S_FINITE, _flat(ev)),
            Segment("eye", S_ORTHO, gram.contiguous(), param=nb),
            Segment("maxabs", S_CHG, _real0(x_mixed), _real0(x_new),
                    scale=om),
            Segment("herm", S_HERM, h_nl.contiguous(), param=nb),
        ]
        if tb.sym is not None:
            segs.append(Segment("maxabs_c", S_SYM,
                                symmetrize_pw(tb.sym, rho_new), rho_new))
        record = scf_record(segs, NUM_SCALARS)

        # the carry, in place
        self.x.copy_(x_mixed)
        self.veff.copy_(veff_new)
        if self.polarized:
            self.bz.copy_(bz_new)
        return StepOut(record=record, pot=pot, d_spin=d_spin, h_diag=h_diag,
                       dm=dm, resid=resid)
