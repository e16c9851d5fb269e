"""Self-contained synthetic systems for benchmarks, compile checks and the
parity tests — no species files needed: an analytic erf-Coulomb local
potential plus Gaussian beta projectors with a small augmentation channel,
shaped like a real ultrasoft silicon run."""

from __future__ import annotations

import numpy as np

from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.crystal.atom_type import (
    AtomType,
    AtomicWf,
    AugmentationChannel,
    BetaProjector,
)


def synthetic_silicon_type(zn: float = 4.0, ultrasoft: bool = True) -> AtomType:
    from scipy.special import erf

    r = np.geomspace(1e-6, 12.0, 700)
    vloc = -zn * erf(r) / r
    # two beta channels (l=0, l=1), smooth nodeless shapes (r*beta(r))
    rb0 = r * np.exp(-(r**2)) * 2.0
    rb1 = r * r * np.exp(-(r**2)) * 1.5
    betas = [BetaProjector(l=0, rbeta=rb0, nr=len(r)), BetaProjector(l=1, rbeta=rb1, nr=len(r))]
    d_ion = np.array([[0.8, 0.0], [0.0, 0.4]])
    aug = []
    if ultrasoft:
        # one l=0 augmentation channel per radial pair (r^2-weighted Gaussians)
        q00 = 0.05 * r**2 * np.exp(-2.0 * r**2)
        q11 = 0.03 * r**2 * np.exp(-2.0 * r**2)
        aug = [
            AugmentationChannel(i=0, j=0, l=0, qr=q00),
            AugmentationChannel(i=1, j=1, l=0, qr=q11),
        ]
    wfs = [
        AtomicWf(l=0, occupation=2.0, chi=r * np.exp(-0.8 * r), label="3S"),
        AtomicWf(l=1, occupation=2.0, chi=r * r * np.exp(-0.8 * r), label="3P"),
    ]
    rho = 4.0 * np.pi * r**2 * (zn * 0.4**3 / np.pi) * np.exp(-0.8 * r) * 0.5
    return AtomType(
        label="Si", symbol="Si", zn=zn, pseudo_type="US" if ultrasoft else "NC",
        r=r, vloc=vloc, beta=betas, d_ion=d_ion, augmentation=aug,
        atomic_wfs=wfs, rho_total=rho, rho_core=None, core_correction=False,
    )


def synthetic_silicon_context(
    gk_cutoff: float = 6.0,
    pw_cutoff: float = 20.0,
    ngridk=(2, 2, 2),
    num_bands: int | None = None,
    ultrasoft: bool = True,
    use_symmetry: bool = True,
    positions: np.ndarray | None = None,
    extra_params: dict | None = None,
    moments: np.ndarray | None = None,
    supercell: int = 1,
) -> SimulationContext:
    """Diamond-Si-like 2-atom cell with the synthetic species.

    supercell=n replicates the cell n x n x n (2 n^3 atoms) — the
    Si-supercell-class bench tier (BASELINE.md flagship regime)."""
    import sirius_tpu_torch.crystal.unit_cell as ucm

    params = {
        "gk_cutoff": gk_cutoff,
        "pw_cutoff": pw_cutoff,
        "ngridk": list(ngridk),
        "use_symmetry": use_symmetry,
        "num_bands": num_bands if num_bands else -1,
        "xc_functionals": ["XC_LDA_X", "XC_LDA_C_PZ"],
        "smearing_width": 0.025,
    }
    if extra_params:
        params.update(extra_params)
    cfg = Config.from_dict({"parameters": params})
    a = 10.26
    lattice = a / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
    t = synthetic_silicon_type(ultrasoft=ultrasoft)
    if positions is None:
        positions = np.array([[0.0, 0, 0], [0.25, 0.25, 0.25]])
    positions = np.asarray(positions, dtype=np.float64)
    if supercell > 1 and moments is not None:
        raise ValueError("supercell>1 with explicit moments: tile them "
                         "yourself (per-atom moments must cover all images)")
    if supercell > 1:
        n = supercell
        shifts = np.array(
            [[i, j, k] for i in range(n) for j in range(n) for k in range(n)],
            dtype=np.float64,
        )
        positions = (
            (positions[None, :, :] + shifts[:, None, :]) / n
        ).reshape(-1, 3)
        lattice = lattice * n
    uc = ucm.UnitCell(
        lattice=lattice,
        atom_types=[t],
        type_of_atom=np.zeros(len(positions), dtype=np.int32),
        positions=positions,
        moments=(
            np.zeros((len(positions), 3))
            if moments is None else np.asarray(moments, float)
        ),
    )
    # SimulationContext.create reads species from files; build the parts
    # directly instead (same code path below the unit-cell level).
    import sirius_tpu_torch.context as cm

    orig = ucm.UnitCell.from_config
    try:
        ucm.UnitCell.from_config = staticmethod(lambda c, b=".": uc)
        ctx = cm.SimulationContext.create(cfg, ".")
    finally:
        ucm.UnitCell.from_config = orig
    return ctx
