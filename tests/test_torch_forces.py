"""Port parity for the forces (sirius_tpu_torch/dft/forces.py) and their
wiring into run_scf under control.print_forces.

(a) Same state: the JAX package runs a short SCF on the small force decks
    (norm-conserving and ultrasoft, the shape and positions of
    tests/test_forces.py, and a polarized PBE deck) with the force and
    stress entries on; its end state, taken where its run_scf hands it to
    total_forces and StressCalculator.compute, goes through
    convert.forces_state_from_numpy into the port's functions. Every force
    term within 1e-10 Ha/bohr of the JAX package's.
(b) The port alone against finite differences of its free energy, as
    tests/test_forces.py holds the JAX package: 5e-5 Ha/bohr on atom 1's x
    component, 1e-5 on the net force, norm-conserving and ultrasoft.
(c) The port's SCF on the recorded force decks against the JAX package's
    records (tools/torch_port_reference.py): forces to 1e-7 Ha/bohr,
    stress to 1e-8 Ha/bohr^3.
(e) The D the forces and stress take: the D of the final potential where
    the JAX package runs its fused step (a k-set deck), the D of the last
    band solve where it runs its host loop (a Gamma and a chunked deck),
    each against a JAX run of the same deck stopped early, where the two D
    differ; and the fp32 bands, widened, against the fp64 run's forces.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from sirius_tpu_torch.convert import forces_state_from_numpy
from sirius_tpu_torch.dft import forces as port_forces
from sirius_tpu_torch.dft import scf as port_scf
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.testing import synthetic_silicon_context
from sirius_tpu_torch.testing import threads_per_test_worker

torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
FM = [[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]]
DISTORTED = [[0.0, 0.0, 0.0], [0.21, 0.27, 0.23]]
MOVED = [[0.0, 0.0, 0.0], [0.26, 0.26, 0.26]]
FORCES_SMALL = dict(gk_cutoff=3.5, pw_cutoff=8.0, ngridk=(1, 1, 1),
                    num_bands=8, use_symmetry=False, positions=DISTORTED)
# the same-state decks: an 8-iteration SCF (the state need not be
# converged for two packages to agree on it)
FIXED_8 = {"num_dft_iter": 8, "density_tol": 0.0, "energy_tol": 0.0}
SAME_STATE = {
    "forces_nc": dict(FORCES_SMALL, ultrasoft=False),
    "forces_us": dict(FORCES_SMALL, ultrasoft=True),
    "small_gamma_pbe_fm_moved": dict(
        gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8,
        ultrasoft=True, use_symmetry=True, positions=MOVED, moments=FM,
        extra={"num_mag_dims": 1, "xc_functionals": PBE}),
}
FORCE_TERMS = ("vloc", "core", "ewald", "nonloc", "us", "scf_corr", "total")


def deck_kwargs(spec: dict, params: dict) -> dict:
    spec = dict(spec)
    extra = dict(params, **spec.pop("extra", {}))
    if spec.get("moments") is not None:
        spec["moments"] = np.asarray(spec["moments"])
    return dict(spec, extra_params=extra)


@functools.cache
def jax_end_state(name: str) -> dict:
    """The JAX package's state where its run_scf hands it to total_forces
    and StressCalculator.compute (sirius_tpu/dft/scf.py:2358-2408), with
    the terms each returned; one run a deck and process."""
    import jax

    import sirius_tpu.dft.forces as jf
    import sirius_tpu.dft.stress as js
    from sirius_tpu.dft.scf import run_scf as jax_run_scf
    from sirius_tpu.testing import synthetic_silicon_context as jax_context

    ctx = jax_context(**deck_kwargs(SAME_STATE[name], FIXED_8))
    ctx.cfg.control.print_forces = True
    ctx.cfg.control.print_stress = True
    cap = {}
    total_forces, compute = jf.total_forces, js.StressCalculator.compute

    def forces_spy(ctx_, rho_g, vxc_g, veff_g, bz_g, psi, occ, evals,
                   d_by_spin, dm_blocks, rho_resid_g=None):
        cap.update(rho_g=rho_g, vxc_g=vxc_g, veff_g=veff_g, bz_g=bz_g,
                   psi=np.asarray(psi), occ=occ, evals=evals,
                   d_by_spin=d_by_spin, dm_blocks_by_spin=dm_blocks,
                   rho_resid_g=rho_resid_g)
        cap["force_terms"] = total_forces(
            ctx_, rho_g, vxc_g, veff_g, bz_g, psi, occ, evals, d_by_spin,
            dm_blocks, rho_resid_g=rho_resid_g)
        return cap["force_terms"]

    def stress_spy(self, rho_g, mag_g, rho_r, mag_r, psi, occ, evals,
                   d_by_spin, dm_blocks_by_spin=None, hub=None):
        cap["mag_g"] = mag_g
        cap["stress_dm"] = dm_blocks_by_spin
        cap["stress_terms"] = compute(self, rho_g, mag_g, rho_r, mag_r, psi,
                                      occ, evals, d_by_spin,
                                      dm_blocks_by_spin, hub)
        return cap["stress_terms"]

    jf.total_forces, js.StressCalculator.compute = forces_spy, stress_spy
    try:
        cap["result"] = jax_run_scf(ctx.cfg, ctx=ctx,
                                    devices=jax.devices()[:1])
    finally:
        jf.total_forces, js.StressCalculator.compute = total_forces, compute
    return cap


def port_context(name: str):
    return synthetic_silicon_context(**deck_kwargs(SAME_STATE[name], FIXED_8))


@pytest.mark.parametrize("name", sorted(SAME_STATE))
def test_force_terms_match_jax_on_the_same_state(name):
    cap = jax_end_state(name)
    ctx = port_context(name)
    st = forces_state_from_numpy(cap, "cpu")
    got = port_forces.total_forces(
        ctx, st["rho_g"], st["vxc_g"], st["veff_g"], st["bz_g"], st["psi"],
        st["occ"], st["evals"], st["d_by_spin"], st["dm_blocks_by_spin"],
        rho_resid_g=st["rho_resid_g"])
    assert sorted(got) == sorted(cap["force_terms"]) == sorted(FORCE_TERMS)
    for term in FORCE_TERMS:
        want = np.asarray(cap["force_terms"][term])
        assert got[term].shape == (2, 3)
        assert np.max(np.abs(got[term] - want)) <= 1e-10, term
    # the deck's forces are not zero by symmetry: the check has a scale
    assert np.max(np.abs(got["total"])) > 1e-3
    if SAME_STATE[name]["ultrasoft"]:
        assert np.max(np.abs(got["us"])) > 1e-6


def test_nonloc_force_masks_unoccupied_bands():
    # a band whose weighted occupation is below 1e-14 carries no force,
    # as the JAX package skips it: a huge eigenvalue on an empty band
    # changes nothing
    cap = jax_end_state("forces_us")
    ctx = port_context("forces_us")
    st = forces_state_from_numpy(cap, "cpu")
    occ = st["occ"].copy()
    evals = st["evals"].copy()
    occ[0, 0, -1] = 1e-15
    evals[0, 0, -1] = 1e6
    base = port_forces.forces_nonloc(ctx, st["psi"], st["occ"], st["evals"],
                                     st["d_by_spin"])
    empty = port_forces.forces_nonloc(ctx, st["psi"], occ, st["evals"],
                                      st["d_by_spin"])
    shifted = port_forces.forces_nonloc(ctx, st["psi"], occ, evals,
                                        st["d_by_spin"])
    assert np.array_equal(empty, shifted)
    assert not np.array_equal(base, empty)


def _fd_run(positions, ultrasoft):
    ctx = synthetic_silicon_context(
        gk_cutoff=3.5, pw_cutoff=8.0, ngridk=(1, 1, 1), num_bands=8,
        ultrasoft=ultrasoft, use_symmetry=False, positions=positions,
        extra_params={"density_tol": 5e-9, "energy_tol": 1e-11,
                      "num_dft_iter": 60})
    ctx.cfg.control.print_forces = True
    ctx.cfg.mixer.beta = 0.7
    return run_scf(ctx.cfg, ctx=ctx, device="cpu")


@pytest.mark.parametrize("ultrasoft", [False, True])
def test_forces_match_finite_difference(ultrasoft):
    base = np.array(DISTORTED)
    res = _fd_run(base, ultrasoft)
    assert res["converged"]
    f = np.asarray(res["forces"])
    assert f.shape == (2, 3)
    assert res["forces_seconds"] > 0
    a = 10.26
    lat = a / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
    h_cart = 2e-3
    dx_frac = np.linalg.solve(lat.T, np.array([h_cart, 0, 0]))
    step = np.array([[0, 0, 0], dx_frac])
    ep = _fd_run(base + step, ultrasoft)["energy"]["free"]
    em = _fd_run(base - step, ultrasoft)["energy"]["free"]
    f_fd = -(ep - em) / (2 * h_cart)
    np.testing.assert_allclose(f[1, 0], f_fd, atol=5e-5)
    np.testing.assert_allclose(f.sum(axis=0), 0.0, atol=1e-5)


def _tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_reference", os.path.join(ROOT, "tools",
                                             "torch_port_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def recorded_context(name: str, tool):
    spec, kind, control, params, moments = tool.deck_spec(name)
    ctx = synthetic_silicon_context(
        extra_params=dict(params), **kind, **spec,
        moments=None if moments is None else np.asarray(moments))
    tool.apply_control(ctx.cfg, control)
    return ctx


# the recorded force decks: the band solve each takes, whether the JAX
# package ran its fused step there
RECORDED = {"forces_nc": ("gamma", False), "forces_us": ("gamma", False),
            "forces_us_sym_2atom": ("kset", True),
            "forces_gamma_pbe_fm": ("gamma", False)}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorded_force_deck_matches_jax(name):
    with open(REF_PATH) as f:
        ref = json.load(f)["decks"][name]
    tool = _tool()
    ctx = recorded_context(name, tool)
    path, fused = RECORDED[name]
    assert ref["band_solve"] == path == port_scf.band_solve_path(ctx.cfg, ctx)
    assert ref["fused"] == fused == port_scf.fuses(ctx.cfg, ctx)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == ref["num_scf_iterations"]
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    df = np.max(np.abs(np.subtract(res["forces"], ref["forces"])))
    ds = np.max(np.abs(np.subtract(res["stress"], ref["stress"])))
    assert df <= 1e-7, df
    assert ds <= 1e-8, ds


# (e): a k-set deck the JAX package fuses, a Gamma deck it runs on its host
# loop, each stopped after 2 iterations, where the D of the last band solve
# and the D of the final potential still differ. So early the two
# packages' band solves agree to ~1e-8 Ha/bohr in the forces and to ~1e-10
# Ha/bohr^3 in the stress, which the wrong D moves by 1.3e-7 and 4.9e-7.
# That early the port's forces move with torch's intra-op thread count (its
# reductions split differently): against the JAX run they land 8e-10 to
# 7.4e-8 Ha/bohr away over 1, 2, 3, 4 and 8 threads (6.5e-9, 8.5e-9 and
# 7.4e-9 at one thread), the stress within 3.7e-10. So the port runs these
# cases on one thread, whatever the worker count of the test run
D_DECKS = {
    "kset_fused": dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2),
                       num_bands=8, ultrasoft=True, use_symmetry=True,
                       positions=MOVED),
    "gamma_host": dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1),
                       num_bands=8, ultrasoft=True, use_symmetry=True,
                       positions=MOVED),
    # the chunked-projector solve, one atom a chunk: a host path too
    "chunked_host": dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1),
                         num_bands=8, ultrasoft=True, use_symmetry=True,
                         positions=MOVED,
                         control={"beta_chunked": True, "beta_chunk_size": 1}),
}
FIXED_2 = {"num_dft_iter": 2, "density_tol": 0.0, "energy_tol": 0.0}


@pytest.mark.parametrize("name", sorted(D_DECKS))
def test_forces_take_the_d_of_the_jax_path(name, monkeypatch):
    import jax

    from sirius_tpu.dft.scf import run_scf as jax_run_scf
    from sirius_tpu.testing import synthetic_silicon_context as jax_context
    from sirius_tpu.utils.profiler import timer_report

    spec = dict(D_DECKS[name])
    control = spec.pop("control", {})
    kw = deck_kwargs(spec, FIXED_2)
    jctx = jax_context(**kw)
    ctx = synthetic_silicon_context(**kw)
    for c in (jctx, ctx):
        c.cfg.control.print_forces = True
        c.cfg.control.print_stress = True
        for key, value in control.items():
            setattr(c.cfg.control, key, value)
    assert port_scf.band_solve_path(ctx.cfg, ctx) == name.split("_")[0]
    want = jax_run_scf(jctx.cfg, ctx=jctx, devices=jax.devices()[:1])
    fused = any("fused" in k for k in timer_report())
    assert fused == (name == "kset_fused") == port_scf.fuses(ctx.cfg, ctx)

    def gaps(res):
        return (np.max(np.abs(np.subtract(res["forces"], want["forces"]))),
                np.max(np.abs(np.subtract(res["stress"], want["stress"]))))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        df, ds = gaps(run_scf(ctx.cfg, ctx=ctx, device="cpu"))
        assert df <= 5e-8 and ds <= 1e-9, (df, ds)
        # the other D moves the stress well past that: the k-set deck's host
        # loop hands its last band solve's D, the Gamma and chunked decks
        # run through the fused k-set step hand the final potential's
        if fused:
            monkeypatch.setattr(port_scf, "fuses", lambda cfg, c: False)
        else:
            monkeypatch.setattr(port_scf, "band_solve_path",
                                lambda cfg, c: "kset")
        assert gaps(run_scf(ctx.cfg, ctx=ctx, device="cpu"))[1] > 3e-8
    finally:
        torch.set_num_threads(threads)


def test_fp32_bands_give_the_fp64_forces():
    # the fp32 k-set path hands forces and stress its complex64 bands
    # widened to complex128 (the JAX package's join_cplx); three iterations
    # in fp32 throughout land within fp32's scatter of the fp64 run's
    kw = deck_kwargs(D_DECKS["kset_fused"],
                     dict(FIXED_2, num_dft_iter=3))
    runs = {}
    for prec in ("fp64", "fp32"):
        ctx = synthetic_silicon_context(**kw)
        ctx.cfg.parameters.precision_wf = prec
        ctx.cfg.control.print_forces = True
        ctx.cfg.control.print_stress = True
        runs[prec] = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert runs["fp32"]["wf_precision"] == ["fp32"] * 3
    df = np.max(np.abs(np.subtract(runs["fp32"]["forces"],
                                   runs["fp64"]["forces"])))
    ds = np.max(np.abs(np.subtract(runs["fp32"]["stress"],
                                   runs["fp64"]["stress"])))
    assert df <= 1e-4 and ds <= 1e-5, (df, ds)
