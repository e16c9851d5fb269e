"""Simulation context: the composition root (reference:
src/context/simulation_context.cpp Simulation_context::initialize, :154).

Builds, from a Config: unit cell + symmetry + irreducible k-mesh, fine
(density/potential, |G| <= pw_cutoff) and coarse (wave-function,
|G| <= 2*gk_cutoff) G-vector sets with their FFT boxes, the fine<->coarse
index map, per-k |G+k| spheres, beta projectors, local-potential / core /
free-atom-density form-factor fields, Ewald energy, and the band count
(nbnd = nval/2 + max(10, 0.1*nval), simulation_context.cpp:333)."""

from __future__ import annotations

import dataclasses

import numpy as np

from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.core.fftgrid import FFTGrid
from sirius_tpu_torch.core.gvec import Gvec, GkVec
from sirius_tpu_torch.crystal.kpoints import irreducible_kmesh
from sirius_tpu_torch.crystal.symmetry import CrystalSymmetry
from sirius_tpu_torch.crystal.unit_cell import UnitCell
from sirius_tpu_torch.dft.ewald import ewald_energy
from sirius_tpu_torch.dft.radial_tables import (
    make_periodic_function,
    rho_core_form_factor,
    rho_total_form_factor,
    structure_factors,
    vloc_ff,
)
from sirius_tpu_torch.ops.augmentation import Augmentation
from sirius_tpu_torch.ops.beta import BetaProjectors


@dataclasses.dataclass
class SimulationContext:
    cfg: Config
    unit_cell: UnitCell
    symmetry: CrystalSymmetry | None
    gvec: Gvec  # fine set (density/potential)
    gvec_coarse: Gvec  # coarse set (wave functions)
    fft_coarse: FFTGrid
    coarse_to_fine: np.ndarray  # fine index of each coarse G
    gkvec: GkVec
    kweights: np.ndarray
    beta: BetaProjectors
    aug: Augmentation | None  # ultrasoft/PAW augmentation, None without
    vloc_g: np.ndarray  # (ng_fine,) local potential
    rho_core_g: np.ndarray  # (ng_fine,)
    rho_atomic_g: np.ndarray  # (ng_fine,) superposition of free atoms
    e_ewald: float
    num_bands: int
    num_spins: int
    num_mag_dims: int

    @staticmethod
    def create(cfg: Config, base_dir: str = ".") -> "SimulationContext":
        p = cfg.parameters
        uc = UnitCell.from_config(cfg.unit_cell, base_dir)
        if p.gk_cutoff <= 0 or p.pw_cutoff <= 0:
            raise ValueError("gk_cutoff and pw_cutoff must be set")
        if p.pw_cutoff < 2 * p.gk_cutoff:
            raise ValueError(
                f"pw_cutoff ({p.pw_cutoff}) must be >= 2*gk_cutoff "
                f"({2 * p.gk_cutoff}) to hold wave-function products"
            )
        sym = None
        if p.use_symmetry:
            sym = CrystalSymmetry.find(
                uc.lattice, uc.positions, uc.type_of_atom, uc.moments, p.num_mag_dims
            )
        kpts, kw = irreducible_kmesh(
            p.ngridk, p.shiftk, sym, use_symmetry=p.use_symmetry and p.use_ibz,
            time_reversal=p.num_mag_dims != 3,
        )
        if len(p.vk):
            kpts = np.asarray(p.vk, dtype=np.float64)
            kw = np.full(len(kpts), 1.0 / len(kpts))

        # fine/coarse FFT boxes: the reference's exact sizing (5-smooth,
        # min grid around the sphere) — the nonlinear XC is evaluated on
        # the fine box, so dims are part of the numerical definition;
        # settings.fft_grid_size (recorded in every reference output)
        # overrides when set
        fgs = cfg.settings.fft_grid_size
        if fgs and all(int(x) > 0 for x in fgs):
            fft_fine = FFTGrid(tuple(int(x) for x in fgs))
        else:
            fft_fine = FFTGrid.ref_min_grid(uc.lattice, p.pw_cutoff)
        gvec = Gvec.build(uc.lattice, p.pw_cutoff, fft=fft_fine)
        fft_coarse = FFTGrid.ref_min_grid(uc.lattice, 2 * p.gk_cutoff)
        gvec_coarse = Gvec.build(uc.lattice, 2 * p.gk_cutoff, fft=fft_coarse)
        c2f = gvec.index_of_millers(gvec_coarse.millers)
        assert np.all(c2f >= 0)
        gkvec = GkVec.build(gvec, kpts, p.gk_cutoff, fft_coarse, weights=kw)
        quantum = int(getattr(cfg.control, "ngk_pad_quantum", 0) or 0)
        if quantum > 0:
            gkvec = gkvec.pad_to(-(-gkvec.ngk_max // quantum) * quantum)

        beta = BetaProjectors.build(uc, gkvec, qmax=p.gk_cutoff + 1e-9)
        aug = None
        if any(t.augmentation for t in uc.atom_types):
            aug = Augmentation.build(uc, gvec)
            # assemble the block-diagonal S-operator integrals q_mtrx
            qmat = np.zeros_like(beta.dion)
            for ia, off, nbf in beta.atom_blocks(uc):
                at = aug.per_type[uc.type_of_atom[ia]]
                if at is not None:
                    qmat[off : off + nbf, off : off + nbf] = at.q_mtrx
            beta = dataclasses.replace(beta, qmat=qmat)
        sfact = structure_factors(uc, gvec)
        vloc_g = make_periodic_function(
            uc, gvec, vloc_ff(cfg.settings.pseudo_grid_cutoff), sfact
        )
        rho_core_g = make_periodic_function(
            uc, gvec, rho_core_form_factor, sfact
        )
        rho_at_g = make_periodic_function(
            uc, gvec, rho_total_form_factor, sfact
        )

        e_ewald = ewald_energy(
            uc.lattice,
            uc.positions,
            np.asarray([uc.atom_types[t].zn for t in uc.type_of_atom]),
            gvec.gcart,
            gvec.millers,
            p.pw_cutoff,
        )
        nval = uc.num_valence_electrons
        nbnd = int(nval / 2.0) + max(10, int(0.1 * nval))
        if p.num_mag_dims == 3:
            nbnd *= 2
        if p.num_bands > 0:
            nbnd = p.num_bands
        elif p.num_fv_states > 0:
            nbnd = p.num_fv_states
        return SimulationContext(
            cfg=cfg,
            unit_cell=uc,
            symmetry=sym,
            gvec=gvec,
            gvec_coarse=gvec_coarse,
            fft_coarse=fft_coarse,
            coarse_to_fine=c2f,
            gkvec=gkvec,
            kweights=kw,
            beta=beta,
            aug=aug,
            vloc_g=vloc_g,
            rho_core_g=rho_core_g,
            rho_atomic_g=rho_at_g,
            e_ewald=e_ewald,
            num_bands=nbnd,
            num_spins=2 if p.num_mag_dims > 0 else 1,
            num_mag_dims=p.num_mag_dims,
        )

    @property
    def max_occupancy(self) -> float:
        return 1.0 if self.num_mag_dims > 0 else 2.0
