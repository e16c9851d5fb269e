from sirius_tpu_torch.crystal.atom_type import AtomType, BetaProjector, AtomicWf
from sirius_tpu_torch.crystal.unit_cell import UnitCell
from sirius_tpu_torch.crystal.symmetry import CrystalSymmetry, SymmetryOp
from sirius_tpu_torch.crystal.kpoints import irreducible_kmesh
