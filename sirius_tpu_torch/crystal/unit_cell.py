"""Unit cell: lattice, atoms, species (reference: src/unit_cell/unit_cell.cpp).

Positions are fractional; lattice rows are a_i in bohr. Construction from the
reference JSON deck format (unit_cell section of sirius.json) is supported
directly, including per-atom initial magnetic moments encoded as positions
with 6 entries [x, y, z, mx, my, mz].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from sirius_tpu_torch.config.schema import UnitCellConfig
from sirius_tpu_torch.crystal.atom_type import AtomType


@dataclasses.dataclass
class UnitCell:
    lattice: np.ndarray  # (3,3) rows a_i [bohr]
    atom_types: list[AtomType]
    type_of_atom: np.ndarray  # (natom,) index into atom_types
    positions: np.ndarray  # (natom, 3) fractional
    moments: np.ndarray  # (natom, 3) initial magnetic moment (mu_B, cartesian)

    @property
    def num_atoms(self) -> int:
        return len(self.positions)

    @property
    def omega(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    @property
    def num_valence_electrons(self) -> float:
        return float(sum(self.atom_types[t].zn for t in self.type_of_atom))

    def atoms_of_type(self, it: int) -> np.ndarray:
        return np.nonzero(self.type_of_atom == it)[0]

    def positions_cart(self) -> np.ndarray:
        return self.positions @ self.lattice

    @staticmethod
    def from_config(uc: UnitCellConfig, base_dir: str = ".") -> "UnitCell":
        lattice = np.asarray(uc.lattice_vectors, dtype=np.float64) * uc.lattice_vectors_scale
        types: list[AtomType] = []
        type_index: dict[str, int] = {}
        for lbl in uc.atom_types:
            if lbl in getattr(uc, "atom_data", {}):
                # array-built in-memory species (C API construction path)
                types.append(AtomType.from_dict(lbl, uc.atom_data[lbl]))
                type_index[lbl] = len(types) - 1
                continue
            fname = uc.atom_files.get(lbl, "")
            path = fname if os.path.isabs(fname) else os.path.join(base_dir, fname)
            if (not path.lower().endswith(".json")) and os.path.exists(path + ".json"):
                # decks may reference a raw UPF name with a converted
                # <name>.json alongside; prefer the JSON (the converter in
                # io/upf.py produces the same layout)
                path = path + ".json"
            elif not os.path.exists(path) and os.path.exists(path + ".json"):
                path = path + ".json"
            # raw .UPF paths with no converted sibling fall through:
            # AtomType.from_file converts them in-process
            types.append(AtomType.from_file(lbl, path))
            type_index[lbl] = len(types) - 1
        t_of_a, pos, mom = [], [], []
        unknown = [l for l in uc.atoms if l not in type_index]
        if unknown:
            raise ValueError(
                f"atom label(s) {unknown} in unit_cell.atoms have no entry "
                "in unit_cell.atom_types / atom_files"
            )
        if len(set(uc.atom_types)) != len(uc.atom_types):
            raise ValueError(
                f"duplicate label(s) in unit_cell.atom_types: {uc.atom_types}"
            )
        # reference atom enumeration follows the atom_types list order, not
        # the "atoms" dict insertion order (forces/moments are reported per
        # atom in that order)
        for lbl in [l for l in uc.atom_types if l in uc.atoms]:
            plist = uc.atoms[lbl]
            for p in plist:
                p = list(p)
                t_of_a.append(type_index[lbl])
                pos.append(p[:3])
                mom.append(p[3:6] if len(p) >= 6 else [0.0, 0.0, 0.0])
        if uc.atom_coordinate_units.startswith("au"):
            pos = (np.asarray(pos, dtype=np.float64) @ np.linalg.inv(lattice)).tolist()
        elif uc.atom_coordinate_units.startswith("A"):
            pos = (np.asarray(pos, dtype=np.float64) / 0.52917721067 @ np.linalg.inv(lattice)).tolist()
        return UnitCell(
            lattice=lattice,
            atom_types=types,
            type_of_atom=np.asarray(t_of_a, dtype=np.int32),
            positions=np.mod(np.asarray(pos, dtype=np.float64), 1.0),
            moments=np.asarray(mom, dtype=np.float64),
        )
