"""Self-contained synthetic systems for benchmarks, compile checks and the
parity tests — no species files needed: an analytic erf-Coulomb local
potential plus Gaussian beta projectors with a small augmentation channel,
shaped like a real ultrasoft silicon run."""

from __future__ import annotations

import os

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


def _synthetic_parameters(gk_cutoff, pw_cutoff, ngridk, num_bands,
                          use_symmetry, extra_params) -> dict:
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
    return params


def _synthetic_geometry(positions, moments, supercell):
    """(lattice, fractional positions, moments) of the diamond-Si-like
    cell, replicated supercell x supercell x supercell."""
    a = 10.26
    lattice = a / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
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
    moments = (np.zeros((len(positions), 3)) if moments is None
               else np.asarray(moments, float))
    return lattice, positions, moments


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

    params = _synthetic_parameters(gk_cutoff, pw_cutoff, ngridk, num_bands,
                                   use_symmetry, extra_params)
    cfg = Config.from_dict({"parameters": params})
    lattice, positions, moments = _synthetic_geometry(positions, moments,
                                                      supercell)
    t = synthetic_silicon_type(ultrasoft=ultrasoft)
    uc = ucm.UnitCell(
        lattice=lattice,
        atom_types=[t],
        type_of_atom=np.zeros(len(positions), dtype=np.int32),
        positions=positions,
        moments=moments,
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


# ---------------------------------------------------------------------------
# Species and decks on disk. Test scaffolding: the file entry points
# (dft/scf.py::run_scf_from_file, cli.py) and the JAX package read the same
# deck from these files; no program path calls them.


def synthetic_silicon_species(ultrasoft: bool = True,
                              spin_orbit: bool = False) -> dict:
    """The synthetic species in the SIRIUS species-JSON layout
    ({"pseudo_potential": ...}, the layout io/upf.py produces). Without
    spin_orbit, AtomType.from_dict gives synthetic_silicon_type's arrays bit
    for bit. With spin_orbit the l = 1 beta is split into j = 1/2 and
    j = 3/2 with distinct radial functions (total_angular_momentum on every
    beta, header.spin_orbit true, D_ion diag(0.8, 0.35, 0.45)), and the
    ultrasoft species carries augmentation channels for both split betas
    and for their cross pair."""
    t = synthetic_silicon_type(ultrasoft=ultrasoft)
    r = t.r
    betas = [{"radial_function": b.rbeta.tolist(), "angular_momentum": b.l}
             for b in t.beta]
    d_ion = t.d_ion
    aug = [(a.i, a.j, a.l, a.qr) for a in t.augmentation]
    if spin_orbit:
        rb1a = r * r * np.exp(-(r**2)) * 1.5
        rb1b = r * r * np.exp(-1.2 * r**2) * 1.6
        betas = [dict(betas[0], total_angular_momentum=0.5),
                 {"radial_function": rb1a.tolist(), "angular_momentum": 1,
                  "total_angular_momentum": 0.5},
                 {"radial_function": rb1b.tolist(), "angular_momentum": 1,
                  "total_angular_momentum": 1.5}]
        d_ion = np.diag([0.8, 0.35, 0.45])
        if ultrasoft:
            q = [0.05, 0.03, 0.01, 0.035]
            aug = [(i, j, 0, qs * r**2 * np.exp(-(2.0 + 0.1 * k) * r**2))
                   for k, ((i, j), qs) in enumerate(zip(
                       ((0, 0), (1, 1), (1, 2), (2, 2)), q))]
    pp = {
        "header": {
            "element": t.symbol,
            "pseudo_type": t.pseudo_type,
            "core_correction": False,
            "z_valence": t.zn,
            "mesh_size": len(r),
            "number_of_wfc": len(t.atomic_wfs),
            "number_of_proj": len(betas),
            "is_ultrasoft": bool(aug),
            "spin_orbit": spin_orbit,
        },
        "radial_grid": r.tolist(),
        "local_potential": t.vloc.tolist(),
        "total_charge_density": t.rho_total.tolist(),
        "beta_projectors": betas,
        "D_ion": np.asarray(d_ion, dtype=np.float64).ravel().tolist(),
        "atomic_wave_functions": [
            {"radial_function": w.chi.tolist(), "angular_momentum": w.l,
             "occupation": w.occupation, "label": w.label}
            for w in t.atomic_wfs],
    }
    if aug:
        pp["augmentation"] = [
            {"i": i, "j": j, "angular_momentum": l,
             "radial_function": np.asarray(qr).tolist()}
            for i, j, l, qr in aug]
    return {"pseudo_potential": pp}


def _floats(values) -> str:
    # repr round-trips every float64 exactly
    return " ".join(repr(float(x)) for x in np.ravel(values))


def write_upf(species: dict, path: str) -> str:
    """Write a species dict of synthetic_silicon_species as a UPF v2 file:
    Ha -> Ry by an exact factor of 2 (local potential, D_ion), floats in
    repr, has_so and total_angular_momentum for a spin-orbit species.
    io/upf.py::upf2_to_json reads it back to the same arrays."""
    pp = species["pseudo_potential"]
    h = pp["header"]
    betas = pp.get("beta_projectors", [])
    so = bool(h.get("spin_orbit", False))

    def flag(v):
        return "T" if v else "F"

    lines = [
        '<UPF version="2.0.1">',
        f'  <PP_HEADER element="{h["element"]}" '
        f'pseudo_type="{h["pseudo_type"]}" z_valence="{h["z_valence"]!r}" '
        f'mesh_size="{len(pp["radial_grid"])}" '
        f'number_of_proj="{len(betas)}" '
        f'number_of_wfc="{len(pp.get("atomic_wave_functions", []))}" '
        f'is_ultrasoft="{flag(h.get("is_ultrasoft", False))}" '
        f'core_correction="{flag(h.get("core_correction", False))}" '
        f'has_so="{flag(so)}"/>',
        f'  <PP_MESH><PP_R>{_floats(pp["radial_grid"])}</PP_R></PP_MESH>',
        "  <PP_LOCAL>"
        f"{_floats(2.0 * np.asarray(pp['local_potential']))}</PP_LOCAL>",
    ]
    if "core_charge_density" in pp:
        lines.append(f"  <PP_NLCC>{_floats(pp['core_charge_density'])}"
                     "</PP_NLCC>")
    lines.append("  <PP_NONLOCAL>")
    for i, b in enumerate(betas, 1):
        rf = b["radial_function"]
        j = (f' total_angular_momentum="{b["total_angular_momentum"]!r}"'
             if so else "")
        lines.append(f'    <PP_BETA.{i} angular_momentum='
                     f'"{b["angular_momentum"]}" cutoff_radius_index='
                     f'"{len(rf)}"{j}>{_floats(rf)}</PP_BETA.{i}>')
    if betas:
        lines.append("    <PP_DIJ>"
                     f"{_floats(2.0 * np.asarray(pp['D_ion']))}</PP_DIJ>")
    if pp.get("augmentation"):
        lines.append('    <PP_AUGMENTATION q_with_l="T">')
        for a in pp["augmentation"]:
            tag = f"PP_QIJL.{a['i'] + 1}.{a['j'] + 1}.{a['angular_momentum']}"
            lines.append(f"      <{tag}>{_floats(a['radial_function'])}"
                         f"</{tag}>")
        lines.append("    </PP_AUGMENTATION>")
    lines.append("  </PP_NONLOCAL>")
    lines.append("  <PP_PSWFC>")
    for i, w in enumerate(pp.get("atomic_wave_functions", []), 1):
        lines.append(f'    <PP_CHI.{i} l="{w["angular_momentum"]}" '
                     f'occupation="{w["occupation"]!r}">'
                     f'{_floats(w["radial_function"])}</PP_CHI.{i}>')
    lines.append("  </PP_PSWFC>")
    if "total_charge_density" in pp:
        lines.append(f"  <PP_RHOATOM>{_floats(pp['total_charge_density'])}"
                     "</PP_RHOATOM>")
    lines.append("</UPF>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def synthetic_silicon_deck(
    gk_cutoff: float = 6.0,
    pw_cutoff: float = 20.0,
    ngridk=(2, 2, 2),
    num_bands: int | None = None,
    use_symmetry: bool = True,
    extra_params: dict | None = None,
    moments: np.ndarray | None = None,
    supercell: int = 1,
) -> dict:
    """The sirius.json dict of synthetic_silicon_context's cell (the same
    parameters, lattice, positions and moments, as floats that JSON keeps
    exactly), with one species "Si" whose file write_deck names."""
    params = _synthetic_parameters(gk_cutoff, pw_cutoff, ngridk, num_bands,
                                   use_symmetry, extra_params)
    lattice, positions, moments = _synthetic_geometry(None, moments,
                                                      supercell)
    deck = {
        "parameters": params,
        "unit_cell": {
            "lattice_vectors": lattice.tolist(),
            "atom_types": ["Si"],
            "atom_files": {},
            "atoms": {"Si": np.concatenate([positions, moments],
                                           axis=1).tolist()},
        },
    }
    return deck


def write_deck(directory: str, cfg_dict: dict, species: dict,
               fmt: str = "json") -> str:
    """Write cfg_dict as <directory>/sirius.json with its one species "Si"
    in <directory>/Si.json (fmt "json") or Si.upf (fmt "upf", write_upf).
    Returns the deck's path."""
    if fmt not in ("json", "upf"):
        raise ValueError(f"fmt must be json or upf, got {fmt!r}")
    import copy
    import json

    os.makedirs(directory, exist_ok=True)
    name = "Si." + fmt
    if fmt == "upf":
        write_upf(species, os.path.join(directory, name))
    else:
        with open(os.path.join(directory, name), "w") as f:
            json.dump(species, f)
    deck = copy.deepcopy(cfg_dict)
    deck["unit_cell"]["atom_files"] = {"Si": name}
    path = os.path.join(directory, "sirius.json")
    with open(path, "w") as f:
        json.dump(deck, f, indent=1)
    return path


def threads_per_test_worker() -> int:
    """Torch intra-op threads for one process of a test run: the CPU cores
    shared evenly among the pytest-xdist workers
    (PYTEST_XDIST_WORKER_COUNT), all of them outside xdist. Torch's default
    gives every worker every core; with 6 workers on 8 cores the port's CPU
    tests ran 11x slower (589 s against 52 s)."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    return max(1, (os.cpu_count() or 1) // workers)

