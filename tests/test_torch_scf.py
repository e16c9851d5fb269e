"""Port parity for the whole path: the small decks' SCF (2x2x2 k-mesh, LDA
X + PZ, Anderson, Gaussian smearing, tight tolerances; norm-conserving
without symmetry, and ultrasoft with the space group and the irreducible
k-mesh) and the three Gamma-only full-width 2-atom decks of the single-k
band solves (packed-real Gamma, norm-conserving and ultrasoft + symmetry;
chunked projectors, ultrasoft + symmetry) and the small collinear PBE
decks (k-point antiferromagnetic, Gamma ferromagnetic) and the small SCAN
meta-GGA decks (norm-conserving; ultrasoft + symmetry, antiferromagnetic)
on the CPU against the JAX package's recorded results in
sirius_tpu_torch/data/jax_reference.json (recomputed by the slow tests
below). Bounds: every energy term and E_F to 1e-8 Ha, the same iteration
count, the recorded electron count to 1e-10, the total and per-atom
moments to 1e-6 (1e-8 on the SCAN decks). Also the band-solve dispatch,
the entry points' device rule and the NotImplementedError branches of what
the port leaves out."""

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
from sirius_tpu_torch.dft.scf import band_solve_path, run_scf
from sirius_tpu_torch.ops.beta_chunked import apply_h_s_chunked, make_chunked_hk
from sirius_tpu_torch.ops.gamma import (apply_h_s_gamma, build_gamma_map,
                                        make_gamma_params)
from sirius_tpu_torch.ops.hamiltonian import make_hk_params
from sirius_tpu_torch.ops.mgga import apply_h_s_mgga
from sirius_tpu_torch.parallel.batched import make_hkset_params
from sirius_tpu_torch.testing import synthetic_silicon_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
US_SYM = dict(ultrasoft=True, use_symmetry=True)
GAMMA_2ATOM = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(1, 1, 1))
# the recorded single-k decks: species and symmetry, SCF parameters,
# control settings, the band solve they take. gamma_nc runs a fixed 24
# iterations: its iteration count to a tolerance is not reproducible even in
# the JAX package (tools/torch_port_reference.py says why)
FIXED_24 = {"num_dft_iter": 24, "density_tol": 0.0, "energy_tol": 0.0}
SINGLE_K = {
    "gamma_nc": (dict(ultrasoft=False, use_symmetry=False), FIXED_24, {},
                 "gamma"),
    "gamma_us_sym": (US_SYM, TIGHT, {}, "gamma"),
    "chunked_us_sym": (US_SYM, TIGHT,
                       {"beta_chunked": True, "beta_chunk_size": 1}, "chunked"),
}


# the small collinear decks: shape, SCF parameters, moments, band solve
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
SPIN_DECKS = {
    "small_pbe_afm": (SMALL, [[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]], "kset"),
    "small_gamma_pbe_fm": (dict(SMALL, ngridk=(1, 1, 1)),
                           [[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]], "gamma"),
}
# the full-width decks of other functionals and spin, run on the card by
# chip_smoke.py and recomputed by the slow test below
XC_DECKS = ("pbe_us_sym", "pw_us_sym_afm", "gamma_pbe_us_sym_fm",
            "gamma_nc_vwn", "gamma_nc_pbesol", "scan_us_sym", "scan_us_sym_fm")
# the small SCAN decks, run here; the tool's deck_spec builds them
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
SCAN_DECKS = ("small_scan_nc", "small_scan_us_afm")
# the non-collinear decks (tests/test_torch_noncollinear.py runs the small
# ones, chip_smoke.py all four)
SPINOR_DECKS = ("small_spinor_us", "small_spinor_pbe_us_sym", "spinor_us",
                "spinor_pbe_us_sym")


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


def assert_matches(res, ref, ctx, electrons=8.0):
    assert res["converged"] == ref["converged"]
    assert res["num_scf_iterations"] == ref["num_scf_iterations"]
    assert abs(res["efermi"] - ref["efermi"]) <= 1e-8
    assert sorted(res["energy"]) == sorted(ref["energy"])
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    assert len(res["iteration_seconds"]) == res["num_scf_iterations"]
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - electrons) <= 1e-10


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


@pytest.mark.parametrize("deck", sorted(SINGLE_K))
def test_single_k_deck_matches_jax(reference, deck):
    """The Gamma-only 2-atom decks through the packed-real and the chunked
    band solves."""
    kind, params, control, path = SINGLE_K[deck]
    ctx = synthetic_silicon_context(extra_params=dict(params), **kind,
                                    **GAMMA_2ATOM)
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    taken, other = ((apply_h_s_gamma, apply_h_s_chunked) if path == "gamma"
                    else (apply_h_s_chunked, apply_h_s_gamma))
    before = (taken.calls, other.calls)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert taken.calls > before[0] and other.calls == before[1]
    # the recorded electron count: 8, but on the chunked deck the JAX
    # package's excess of 1.7e-10 (the bands are S-normalized with the
    # interpolated projectors, rho_aug takes the dense table)
    assert_matches(res, reference[deck], ctx,
                   electrons=reference[deck]["electrons"])


@pytest.mark.parametrize("deck", sorted(SPIN_DECKS))
def test_spin_deck_matches_jax(reference, deck):
    """Collinear PBE, ultrasoft + the magnetic space group: the k-set solve
    over both spins (antiferromagnetic start, 8 ops of which 4 flip the
    spin) and the Gamma packed-real solve one spin at a time
    (ferromagnetic start)."""
    shape, moments, path = SPIN_DECKS[deck]
    ref = reference[deck]
    ctx = synthetic_silicon_context(
        extra_params=dict(TIGHT, xc_functionals=PBE, num_mag_dims=1),
        moments=np.asarray(moments), **US_SYM, **shape)
    assert ctx.num_spins == 2 and band_solve_path(ctx.cfg, ctx) == path
    calls = apply_h_s_gamma.calls
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert (apply_h_s_gamma.calls > calls) == (path == "gamma")
    assert_matches(res, ref, ctx)
    got = res["magnetisation"]
    assert abs(got["total"][2] - ref["magnetisation"]["total"]) <= 1e-6
    for a, b in zip(got["atoms"], ref["magnetisation"]["atoms"]):
        assert abs(a[2] - b) <= 1e-6
    assert len(res["mag_history"]) == res["num_scf_iterations"]
    assert np.array(res["band_energies"]).shape[1] == 2


@pytest.mark.parametrize("deck", SCAN_DECKS)
def test_scan_deck_matches_jax(reference, deck):
    """SCAN on the k-set solve with the tau operator: norm-conserving
    without symmetry, and ultrasoft + the magnetic space group with moments
    +0.5 / -0.5 (tau symmetrized per spin, the ultrasoft warning; the
    state relaxes to zero moments, see test_torch_mgga.py::
    test_tau_symmetrization_under_spin_flip_ops for tau with a moment)."""
    shape, kind, control, params, moments = \
        _load_reference_tool().deck_spec(deck)
    ref = reference[deck]
    ctx = synthetic_silicon_context(
        extra_params=dict(params), **kind, **shape,
        moments=None if moments is None else np.asarray(moments))
    assert control == {} and band_solve_path(ctx.cfg, ctx) == "kset"
    calls = apply_h_s_mgga.calls
    if ctx.aug is not None:
        with pytest.warns(UserWarning, match="mGGA with ultrasoft"):
            res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    else:
        res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert apply_h_s_mgga.calls > calls
    assert_matches(res, ref, ctx)
    if moments is not None:
        got = res["magnetisation"]
        assert abs(got["total"][2] - ref["magnetisation"]["total"]) <= 1e-8
        for a, b in zip(got["atoms"], ref["magnetisation"]["atoms"]):
            assert abs(a[2] - b) <= 1e-8


@pytest.mark.parametrize("control,ngridk", [
    ({}, (1, 1, 1)),
    ({"beta_chunked": "force"}, (1, 1, 1)),
    ({"beta_chunked": True, "beta_chunk_size": 1}, (1, 1, 1)),
    ({"beta_chunk_budget_bytes": 1.0}, (1, 1, 1)),
    ({}, (2, 2, 2)),
])
def test_mgga_takes_the_kset_solve(control, ngridk):
    # the JAX package keeps meta-GGA on the k-set solve whatever the k-set
    # and control (scf.py:689, :709): Gamma-only with reduce_gvec and forced
    # chunked projectors included
    ctx = context({"xc_functionals": SCAN}, ngridk=ngridk)
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    assert band_solve_path(ctx.cfg, ctx) == "kset"
    if ngridk == (1, 1, 1) and not control:
        assert ctx.cfg.control.reduce_gvec
        ctx.cfg.parameters.num_dft_iter = 2
        gamma, mgga = apply_h_s_gamma.calls, apply_h_s_mgga.calls
        res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
        assert apply_h_s_gamma.calls == gamma and apply_h_s_mgga.calls > mgga
        assert np.isfinite(res["energy"]["total"])


def test_reference_file_names_its_command(reference):
    with open(REF_PATH) as f:
        rec = json.load(f)
    assert rec["command"] == _load_reference_tool().COMMAND
    # the fp32 decks, each beside its fp64 twin with the JAX package's own
    # fp32-vs-fp64 gap (tests/test_torch_precision.py, chip_smoke.py)
    twins = _load_reference_tool().FP32_TWINS
    forces = _load_reference_tool().FORCES_DECKS
    # the quasi-Newton mixer decks (tests/test_torch_mixer.py) and the
    # spin-orbit decks read from files (tests/test_torch_spin_orbit.py)
    mixers = {f"{prefix}{kind}{suffix}"
              for kind in ("anderson_stable", "broyden2")
              for prefix, suffix in (("small_us_sym_", ""), ("", "_us_sym"))}
    files = _load_reference_tool().FILE_DECKS
    # the JAX package's fused step, one record an iteration
    # (tests/test_torch_fused.py, chip_smoke.py::parity_fused_record)
    fused = _load_reference_tool().FUSED_DECKS
    assert set(reference) == {"small", "full_width_2atom", "small_us_sym",
                              "full_width_2atom_us_sym", *SINGLE_K,
                              *SPIN_DECKS, *XC_DECKS, *SCAN_DECKS,
                              *SPINOR_DECKS, *twins, *twins.values(),
                              *forces, *mixers, *files, *fused}
    for name in fused:
        rec = reference[name]
        assert rec["deck"]["control"]["device_scf"] == "auto"
        assert len(rec["scf_scalars"]) == rec["num_scf_iterations"]
    for name in files:
        rec = reference[name]
        assert rec["deck"]["so_correction"] and rec["deck"]["spin_orbit"]
        assert rec["term_spread"] >= 0 and rec["moment_spread"] >= 0
        assert len(rec["spread_seeds"]) == 3
    # the force decks (tests/test_torch_forces.py, chip_smoke.py) carry the
    # forces, the stress and the JAX package's own spread of both
    for name in forces:
        rec = reference[name]
        assert rec["deck"]["control"]["print_forces"]
        assert rec["deck"]["control"]["print_stress"]
        assert np.shape(rec["forces"]) == (2, 3)
        assert np.shape(rec["stress"]) == (3, 3)
        assert rec["forces_spread"] >= 0 and rec["stress_spread"] >= 0
        assert len(rec["spread_seeds"]) == 3
        assert rec["deck"]["density_tol"] == rec["deck"]["energy_tol"] == 0
    for name, twin in twins.items():
        assert reference[name]["deck"]["precision_wf"] == "fp32"
        assert reference[name]["twin"] == twin
        assert reference[twin]["deck"].get("precision_wf", "fp64") == "fp64"
        # the largest gap over the deck's fp32 runs: the record alone with
        # the polish, the record and two from perturbed starts without
        rec = reference[name]
        assert rec["twin_runs"] == (1 if "fp32_to_fp64_rms" in rec["deck"].get(
            "control", {}) else 3)
        assert rec["twin_max_gap"] >= max(map(abs, rec["twin_gap"].values()))
    for name in SPINOR_DECKS:
        assert reference[name]["deck"]["num_mag_dims"] == 3
        assert len(reference[name]["magnetisation"]["total"]) == 3
    for name in (*SCAN_DECKS, "scan_us_sym", "scan_us_sym_fm"):
        assert reference[name]["deck"]["xc_functionals"] == SCAN
    for name in SPIN_DECKS:
        assert reference[name]["deck"]["xc_functionals"] == PBE
        assert reference[name]["deck"]["moments"] == SPIN_DECKS[name][1]
        assert len(reference[name]["magnetisation"]["atoms"]) == 2
    for name in ("small_us_sym", "full_width_2atom_us_sym", "gamma_us_sym",
                 "chunked_us_sym"):
        assert reference[name]["deck"]["ultrasoft"]
        assert reference[name]["deck"]["use_symmetry"]
    # decks whose stop at a tolerance moves with rounding carry the JAX
    # package's counts from perturbed starts (chip_smoke.iteration_span)
    tool = _load_reference_tool()
    for name in tool.PERTURBED:
        its = reference[name]["perturbed_iterations"]
        assert len(its) == len(tool.PERTURBED_SEEDS)
        assert reference[name]["deck"]["num_dft_iter"] > max(its)
    for name in SINGLE_K:
        assert reference[name]["deck"]["ngridk"] == [1, 1, 1]
        assert reference[name]["deck"].get("control", {}) == SINGLE_K[name][2]
        for key, value in SINGLE_K[name][1].items():
            assert reference[name]["deck"][key] == value


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = context()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scf(ctx.cfg, ctx=ctx)
    assert port_scf.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["make_hk_params", "make_hkset_params",
                                   "Mixer", "grid_tables", "psi_from_numpy",
                                   "make_gamma_params", "make_chunked_hk"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = context(ngridk=(1, 1, 1)) if entry in (
        "make_gamma_params", "make_chunked_hk") else context()
    veff = np.zeros(ctx.fft_coarse.dims)
    call = {
        "make_gamma_params": lambda: make_gamma_params(
            ctx, veff, build_gamma_map(ctx.gkvec.millers[0],
                                       ctx.gkvec.mask[0])),
        "make_chunked_hk": lambda: make_chunked_hk(ctx, 0),
        "make_hk_params": lambda: make_hk_params(ctx, 0, veff),
        "make_hkset_params": lambda: make_hkset_params(ctx, veff),
        "Mixer": lambda: Mixer(ctx.cfg.mixer, ctx.gvec.glen2,
                               omega=ctx.unit_cell.omega),
        "grid_tables": lambda: grid_tables(ctx, None),
        "psi_from_numpy": lambda: psi_from_numpy(np.zeros(3), None),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# cases that raised in earlier slices and run now: collinear spin, GGA,
# SCAN, non-collinear spin, the fp32 wave functions, the anderson_stable
# and broyden2 mixers, and so_correction, which a collinear deck ignores as
# the JAX package's does (ROADMAP queue 3 item 15)
NOW_IN_SLICE = ("magnetism", "GGA", "SCAN", "non-collinear", "fp32",
                "spin-orbit", "broyden2", "anderson_stable")


@pytest.mark.parametrize("section,key,value,match", [
    ("parameters", "precision_wf", "fp32", "fp32"),
    ("parameters", "so_correction", True, "spin-orbit"),
    ("parameters", "num_mag_dims", 1, "magnetism"),
    ("parameters", "hubbard_correction", True, "Hubbard"),
    ("parameters", "xc_functionals", ["XC_GGA_X_PBE", "XC_GGA_C_PBE"], "GGA"),
    ("mixer", "type", "broyden2", "broyden2"),
    ("parameters", "num_mag_dims", 3, "non-collinear"),
    ("parameters", "xc_functionals", ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"],
     "SCAN"),
    ("mixer", "type", "anderson_stable", "anderson_stable"),
])
def test_outside_the_slice_raises(section, key, value, match):
    if match in NOW_IN_SLICE:
        # inside the slice now: two iterations run, and a spin-polarized
        # run reports its moments (the context is built with the setting:
        # the spin count is the context's)
        if section == "parameters":
            ctx = context({"num_dft_iter": 2, key: value})
        else:
            ctx = context({"num_dft_iter": 2})
            setattr(getattr(ctx.cfg, section), key, value)
        res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
        assert res["num_scf_iterations"] == 2
        assert np.isfinite(res["energy"]["total"])
        assert ("magnetisation" in res) == (key == "num_mag_dims")
        return
    ctx = context({"num_dft_iter": 2})
    setattr(getattr(ctx.cfg, section), key, value)
    with pytest.raises(NotImplementedError, match=match) as err:
        run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert "ROADMAP" in str(err.value)


def test_gamma_only_reduce_gvec_raises():
    # a Gamma-only deck with reduce_gvec (the default) runs the packed-real
    # band solve; what still raises there is what raises on every path
    ctx = context({"num_dft_iter": 2}, ngridk=(1, 1, 1))
    assert ctx.cfg.control.reduce_gvec
    calls = apply_h_s_gamma.calls
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert apply_h_s_gamma.calls > calls
    assert res["num_scf_iterations"] == 2
    assert np.isfinite(res["energy"]["total"])
    # fp32 runs there too, on float32 packed blocks; another precision
    # string raises as in the JAX package
    f32 = context({"num_dft_iter": 2, "precision_wf": "fp32"},
                  ngridk=(1, 1, 1))
    calls = apply_h_s_gamma.calls
    res = run_scf(f32.cfg, ctx=f32, device="cpu")
    assert apply_h_s_gamma.calls > calls
    assert res["wf_precision"] == ["fp32", "fp32"]
    assert np.isfinite(res["energy"]["total"])
    bad = context(ngridk=(1, 1, 1))
    bad.cfg.parameters.precision_wf = "fp16"
    with pytest.raises(ValueError, match="fp32 or fp64"):
        run_scf(bad.cfg, ctx=bad, device="cpu")
    # a non-collinear Gamma-only deck takes the spinor k-set solve, as the
    # JAX package hands it to run_scf_nc before the Gamma branch
    nc = context({"num_dft_iter": 2, "num_mag_dims": 3}, ngridk=(1, 1, 1),
                 num_bands=16)
    assert band_solve_path(nc.cfg, nc) == "kset_nc"
    calls = apply_h_s_gamma.calls
    res = run_scf(nc.cfg, ctx=nc, device="cpu")
    assert apply_h_s_gamma.calls == calls
    assert res["num_scf_iterations"] == 2
    assert np.isfinite(res["energy"]["total"])


@pytest.mark.parametrize("control,ngridk,want", [
    ({}, (1, 1, 1), "gamma"),
    ({"reduce_gvec": False}, (1, 1, 1), "kset"),
    ({}, (2, 2, 2), "kset"),
    ({"beta_chunked": True}, (1, 1, 1), "chunked"),
    ({"beta_chunked": "force", "reduce_gvec": False}, (1, 1, 1), "chunked"),
    ({"beta_chunked": True}, (2, 2, 2), "kset"),
    ({"beta_chunk_budget_bytes": 1.0}, (1, 1, 1), "chunked"),
    ({"beta_chunk_budget_bytes": 1.0, "beta_chunked": False}, (1, 1, 1),
     "gamma"),
])
def test_band_solve_dispatch(control, ngridk, want):
    # the JAX package's single-device order: chunked projectors first
    # (forced, or "auto" over budget), then Gamma packed-real
    ctx = context(ngridk=ngridk)
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    assert band_solve_path(ctx.cfg, ctx) == want


def test_chunked_path_runs_norm_conserving():
    # the chunked band solve without augmentation: no dense projector
    # table on the device, S = 1
    ctx = context({"num_dft_iter": 2}, ngridk=(1, 1, 1))
    ctx.cfg.control.beta_chunked = True
    ctx.cfg.control.beta_chunk_size = 1
    calls = apply_h_s_chunked.calls
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert apply_h_s_chunked.calls > calls
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10


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
        for key, want in ref.get("magnetisation", {}).items():
            assert np.max(np.abs(np.subtract(got["magnetisation"][key],
                                             want))) <= 1e-10, (deck, key)
        for key in ("forces", "stress"):
            if key in ref:
                assert np.max(np.abs(np.subtract(got[key], ref[key]))) \
                    <= 1e-10, (deck, key)
