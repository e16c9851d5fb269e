"""Atom species: pseudopotential data parsed from the reference's JSON format.

The reference parses UPF-converted JSON species files in
src/unit_cell/atom_type.cpp:376-490 (read_pseudo_uspp / read_pseudo_paw);
the same files (verification/test*/ *.UPF.json) load here unchanged, and a
raw UPF v2 file is converted in process (io/upf.py).

Structure of a species file:
  pseudo_potential:
    header: {element, z_valence, mesh_size, number_of_proj, l_max,
             pseudo_type: NC|US|USPP|PAW, core_correction, ...}
    radial_grid: [r_i]                    (bohr)
    local_potential: [V_loc(r_i)]         (Ha; UPF stores Ry -> converter halves)
    beta_projectors: [{angular_momentum, radial_function (r*beta),
                       cutoff_radius, ...}]
    D_ion: flattened (nbeta x nbeta)      (Ha)
    augmentation: [{i, j, angular_momentum, radial_function}]  (US/PAW)
    atomic_wave_functions: [{angular_momentum, occupation, radial_function,
                             label}]
    total_charge_density: [4 pi r^2 rho(r)]-like; see rho_at handling
    core_charge_density: [rho_core(r)]
    paw_data: {...}                        (PAW only)
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class BetaProjector:
    l: int
    rbeta: np.ndarray  # r * beta(r) on the (possibly truncated) radial grid
    nr: int  # number of grid points carried
    j: float | None = None  # total angular momentum (relativistic pseudos)


@dataclasses.dataclass
class AtomicWf:
    l: int
    occupation: float
    chi: np.ndarray  # chi(r) (UPF convention: r * phi(r))
    label: str = ""


@dataclasses.dataclass
class AugmentationChannel:
    i: int  # beta index
    j: int  # beta index (j >= i)
    l: int  # angular momentum of the expansion channel
    qr: np.ndarray  # Q_ij^l(r) radial function


@dataclasses.dataclass
class AtomType:
    label: str
    symbol: str
    zn: float  # valence charge z_valence
    pseudo_type: str  # NC | US | PAW
    r: np.ndarray  # radial grid
    vloc: np.ndarray  # local potential V_loc(r) [Ha]
    beta: list[BetaProjector]
    d_ion: np.ndarray  # (nbeta, nbeta) [Ha]
    augmentation: list[AugmentationChannel]
    atomic_wfs: list[AtomicWf]
    rho_total: np.ndarray | None  # free-atom valence charge (UPF: 4 pi r^2 rho)
    rho_core: np.ndarray | None  # core charge density rho_core(r)
    core_correction: bool
    paw: dict | None = None
    paw_core_energy: float = 0.0
    cutoff_radius_index: int | None = None  # PAW partial-wave truncation
    mass: float = 0.0  # atomic mass [amu] from the species file (0 = unset)

    @property
    def spin_orbit(self) -> bool:
        """Relativistic (j-resolved) projectors present (reference
        atom_type spin_orbit_coupling, set from the UPF header)."""
        return any(b.j is not None for b in self.beta)

    @property
    def num_beta(self) -> int:
        return len(self.beta)

    @property
    def lmax_beta(self) -> int:
        return max((b.l for b in self.beta), default=-1)

    @property
    def num_beta_lm(self) -> int:
        """Total projectors counting m-degeneracy: the xi index."""
        return sum(2 * b.l + 1 for b in self.beta)

    def beta_lm_table(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flattened xi -> (radial index, l, m) maps, ordered per projector
        then m = -l..l (reference basis_functions_index convention)."""
        idxrf, ls, ms = [], [], []
        for i, b in enumerate(self.beta):
            for m in range(-b.l, b.l + 1):
                idxrf.append(i)
                ls.append(b.l)
                ms.append(m)
        return np.asarray(idxrf), np.asarray(ls), np.asarray(ms)

    @property
    def num_atomic_wf_lm(self) -> int:
        return sum(2 * w.l + 1 for w in self.atomic_wfs)

    @staticmethod
    def from_file(label: str, path: str) -> "AtomType":
        if path.lower().endswith(".upf"):
            # raw UPF v2: converted in process (deck directories may be
            # read-only, so the dict stays in memory)
            from sirius_tpu_torch.io.upf import upf2_to_json

            return AtomType.from_dict(label, upf2_to_json(path))
        with open(path) as f:
            data = json.load(f)
        return AtomType.from_dict(label, data)

    @staticmethod
    def from_dict(label: str, data: dict) -> "AtomType":
        pp = data["pseudo_potential"]
        h = pp["header"]
        r = np.asarray(pp["radial_grid"], dtype=np.float64)
        nr = len(r)
        vloc = np.asarray(pp["local_potential"], dtype=np.float64)
        betas = []
        for b in pp.get("beta_projectors", []):
            rb = np.asarray(b["radial_function"], dtype=np.float64)
            betas.append(
                BetaProjector(
                    l=int(b["angular_momentum"]), rbeta=rb, nr=len(rb),
                    j=(
                        float(b["total_angular_momentum"])
                        if "total_angular_momentum" in b
                        else None
                    ),
                )
            )
        nb = len(betas)
        d_ion = np.asarray(pp.get("D_ion", np.zeros(nb * nb)), dtype=np.float64).reshape(nb, nb) if nb else np.zeros((0, 0))
        aug = []
        for a in pp.get("augmentation", []):
            aug.append(
                AugmentationChannel(
                    i=int(a["i"]),
                    j=int(a["j"]),
                    l=int(a["angular_momentum"]),
                    qr=np.asarray(a["radial_function"], dtype=np.float64)[:nr],
                )
            )
        wfs = []
        for w in pp.get("atomic_wave_functions", []):
            wfs.append(
                AtomicWf(
                    l=int(w["angular_momentum"]),
                    occupation=float(w.get("occupation", 0.0)),
                    chi=np.asarray(w["radial_function"], dtype=np.float64)[:nr],
                    label=w.get("label", ""),
                )
            )
        ptype = h.get("pseudo_type", "NC")
        if ptype in ("US", "USPP", "SL", "1/r"):
            ptype = "US" if aug else "NC"
        rho_tot = pp.get("total_charge_density")
        rho_core = pp.get("core_charge_density")
        return AtomType(
            label=label,
            symbol=h.get("element", label).strip(),
            zn=float(h["z_valence"]),
            pseudo_type="PAW" if h.get("pseudo_type") == "PAW" else ptype,
            r=r,
            vloc=vloc,
            beta=betas,
            d_ion=d_ion,
            augmentation=aug,
            atomic_wfs=wfs,
            rho_total=np.asarray(rho_tot, dtype=np.float64) if rho_tot is not None else None,
            rho_core=np.asarray(rho_core, dtype=np.float64)[:nr] if rho_core is not None else None,
            core_correction=bool(h.get("core_correction", False)),
            mass=float(h.get("mass", data.get("mass", 0.0)) or 0.0),
            paw=pp.get("paw_data"),
            paw_core_energy=float(h.get("paw_core_energy", 0.0)),
            cutoff_radius_index=(
                int(h["cutoff_radius_index"]) if "cutoff_radius_index" in h else None
            ),
        )
