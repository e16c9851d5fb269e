"""Port parity for the whole path: the small decks' SCF (2x2x2 k-mesh, LDA
X + PZ, Anderson, Gaussian smearing, tight tolerances; norm-conserving
without symmetry, and ultrasoft with the space group and the irreducible
k-mesh) on the CPU against the JAX package's recorded results in
sirius_tpu_torch/data/jax_reference.json (recomputed by the slow tests
below). Bounds: every energy term and E_F to 1e-8 Ha, the same iteration
count. Also the entry points' device rule and the NotImplementedError
branches of what the port leaves out."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sirius_tpu_torch.convert import psi_from_numpy
from sirius_tpu_torch.dft import scf as port_scf
from sirius_tpu_torch.dft.density import grid_tables
from sirius_tpu_torch.dft.mixer import Mixer
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.ops.hamiltonian import make_hk_params
from sirius_tpu_torch.parallel.batched import make_hkset_params
from sirius_tpu_torch.testing import synthetic_silicon_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
US_SYM = dict(ultrasoft=True, use_symmetry=True)


def _load_reference_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference", os.path.join(ROOT, "tools", "torch_port_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    with open(REF_PATH) as f:
        return json.load(f)["decks"]


def context(extra=None, **kw):
    params = dict(TIGHT)
    params.update(extra or {})
    spec = dict(SMALL, ultrasoft=False, use_symmetry=False)
    spec.update(kw)
    return synthetic_silicon_context(extra_params=params, **spec)


def assert_matches(res, ref, ctx):
    assert res["converged"]
    assert res["num_scf_iterations"] == ref["num_scf_iterations"]
    assert abs(res["efermi"] - ref["efermi"]) <= 1e-8
    assert sorted(res["energy"]) == sorted(ref["energy"])
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    assert len(res["iteration_seconds"]) == res["num_scf_iterations"]
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10


def test_small_us_sym_deck_matches_jax(reference):
    ref = reference["small_us_sym"]
    assert ref["num_scf_iterations"] == 13
    ctx = context(**US_SYM)
    assert ctx.gkvec.num_kpoints == 3 and ctx.symmetry.num_ops == 48
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert_matches(res, ref, ctx)


def test_small_deck_matches_jax(reference):
    ref = reference["small"]
    ctx = context()
    assert_matches(run_scf(ctx.cfg, ctx=ctx, device="cpu"), ref, ctx)


def test_reference_file_names_its_command(reference):
    with open(REF_PATH) as f:
        rec = json.load(f)
    assert rec["command"] == _load_reference_tool().COMMAND
    assert set(reference) == {"small", "full_width_2atom", "small_us_sym",
                              "full_width_2atom_us_sym"}
    for name in ("small_us_sym", "full_width_2atom_us_sym"):
        assert reference[name]["deck"]["ultrasoft"]
        assert reference[name]["deck"]["use_symmetry"]


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = context()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scf(ctx.cfg, ctx=ctx)
    assert port_scf.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["make_hk_params", "make_hkset_params",
                                   "Mixer", "grid_tables", "psi_from_numpy"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = context()
    veff = np.zeros(ctx.fft_coarse.dims)
    call = {
        "make_hk_params": lambda: make_hk_params(ctx, 0, veff),
        "make_hkset_params": lambda: make_hkset_params(ctx, veff),
        "Mixer": lambda: Mixer(ctx.cfg.mixer, ctx.gvec.glen2,
                               omega=ctx.unit_cell.omega),
        "grid_tables": lambda: grid_tables(ctx, None),
        "psi_from_numpy": lambda: psi_from_numpy(np.zeros(3), None),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("section,key,value,match", [
    ("parameters", "precision_wf", "fp32", "fp32"),
    ("parameters", "so_correction", True, "spin-orbit"),
    ("parameters", "num_mag_dims", 1, "magnetism"),
    ("parameters", "hubbard_correction", True, "Hubbard"),
    ("parameters", "xc_functionals", ["XC_GGA_X_PBE", "XC_GGA_C_PBE"], "GGA"),
    ("mixer", "type", "broyden2", "broyden2"),
])
def test_outside_the_slice_raises(section, key, value, match):
    ctx = context()
    setattr(getattr(ctx.cfg, section), key, value)
    with pytest.raises(NotImplementedError, match=match):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")


def test_gamma_only_reduce_gvec_raises():
    ctx = context(ngridk=(1, 1, 1))
    assert ctx.cfg.control.reduce_gvec
    with pytest.raises(NotImplementedError, match="K8"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")


def test_gamma_only_without_reduce_gvec_runs():
    ctx = context({"num_dft_iter": 2}, ngridk=(1, 1, 1))
    ctx.cfg.control.reduce_gvec = False
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == 2
    assert np.isfinite(res["energy"]["total"])


def test_ultrasoft_context_raises():
    # an ultrasoft deck without symmetry runs (D refreshed from the
    # potential, rho_aug added, S carried by the band solve) and keeps its
    # electrons; a PAW species is refused
    ctx = context({"num_dft_iter": 2}, ultrasoft=True)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == 2
    assert np.isfinite(res["energy"]["total"])
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10
    ctx.unit_cell.atom_types[0].pseudo_type = "PAW"
    with pytest.raises(NotImplementedError, match="PAW"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")


def test_symmetry_deck_first_iteration():
    # use_symmetry=True on the norm-conserving cell: the irreducible k-mesh
    # and the symmetrized density and potential (K6); one iteration, the
    # electron count exact and the energy equal to the full-mesh deck's
    # first iteration within the symmetrization's rounding
    sym = context({"num_dft_iter": 1}, use_symmetry=True)
    full = context({"num_dft_iter": 1})
    assert sym.gkvec.num_kpoints < full.gkvec.num_kpoints
    r_sym = run_scf(sym.cfg, ctx=sym, device="cpu")
    r_full = run_scf(full.cfg, ctx=full, device="cpu")
    nel = float(r_sym["_state"]["rho_g"][0].real) * sym.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10
    assert abs(r_sym["energy"]["total"] - r_full["energy"]["total"]) <= 1e-6


def test_linear_mixer_runs():
    ctx = context({"num_dft_iter": 3})
    ctx.cfg.mixer.type = "linear"
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == 3
    assert res["rms_history"][-1] < res["rms_history"][0]


@pytest.mark.slow
def test_small_us_sym_deck_matches_live_jax():
    """The small ultrasoft + symmetry deck against a JAX run made now."""
    want = _load_reference_tool().run_deck("small_us_sym")
    ctx = context(**US_SYM)
    assert_matches(run_scf(ctx.cfg, ctx=ctx, device="cpu"), want, ctx)


@pytest.mark.slow
def test_recorded_reference_is_current(reference):
    """Recompute the JAX package's numbers of jax_reference.json."""
    tool = _load_reference_tool()
    for deck, ref in reference.items():
        got = tool.run_deck(deck)
        assert got["num_scf_iterations"] == ref["num_scf_iterations"], deck
        for key, want in ref["energy"].items():
            assert abs(got["energy"][key] - want) <= 1e-10, (deck, key)
