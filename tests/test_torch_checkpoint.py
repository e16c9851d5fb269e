"""The port's checkpoint (sirius_tpu_torch/io/checkpoint.py on io/h5.py)
against the JAX package's (sirius_tpu/io/checkpoint.py on h5py), and the
port's autosave and resume (dft/scf.py::run_scf).

- Cross-loads: one synthetic state (US, unpolarized and polarized, and
  NC) saved by each package loads through both, every field bit for bit
  (dtype and shape too), and each package's validate_checkpoint accepts
  the other's file; the two files carry the same sha256 digest.
- Validation: a corrupted dataset fails 'sha256' (and loads with the
  check waived), a future schema 'version', another cutoff 'millers', a
  missing file 'exist', as tests/test_checkpoint.py holds the JAX
  package's.
- The interrupted save keeps the previous file and leaves no temp file;
  rotate_keep shifts generations and find_resumable falls back past a
  truncated newest one.
- The Miller remap across a 1 % strain gives the JAX package's arrays.
- Resume on the k-set deck (ngridk 2x2x2: the 1-k deck of the JAX tests
  takes the Gamma path on one device and never fuses): killed after the
  iteration-5 autosave, the host loop resumes bit for bit (energy,
  iteration count, etot_history's tail), the fused step within 1e-10 Ha;
  a JAX autosave resumed by the port and a port autosave resumed by the
  JAX package land within 1e-8 Ha of the other package's uninterrupted
  run; save_to writes a final state the JAX package loads, and
  restart_from warm-starts from it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sirius_tpu.config.schema import load_config as jax_load_config
from sirius_tpu.context import SimulationContext as JaxContext
from sirius_tpu.dft.scf import run_scf as jax_run_scf
from sirius_tpu.io import checkpoint as jck
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu.utils import faults as jax_faults
from sirius_tpu_torch.config.schema import load_config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.io import checkpoint as tck
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      synthetic_silicon_deck,
                                      synthetic_silicon_species,
                                      threads_per_test_worker, write_deck)
from sirius_tpu_torch.utils import faults

torch.set_num_threads(threads_per_test_worker())

TINY = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=4,
            use_symmetry=False)
KINDS = {"nc": dict(ultrasoft=False), "us": dict(ultrasoft=True),
         "us_polarized": dict(ultrasoft=True,
                              moments=np.array([[0, 0, 0.5], [0, 0, 0.3]]),
                              extra_params={"num_mag_dims": 1})}
RESUME_DECK = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2),
                   num_bands=8, ultrasoft=True, use_symmetry=False,
                   extra_params={"num_dft_iter": 40, "density_tol": 5e-9,
                                 "energy_tol": 1e-10})


@pytest.fixture(autouse=True)
def no_fault_plans():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def state_of(ctx, polarized, seed=0):
    rng = np.random.default_rng(seed)
    ng = ctx.gvec.num_gvec
    nk, ns, nb = ctx.gkvec.num_kpoints, ctx.num_spins, ctx.num_bands
    ngk = ctx.gkvec.ngk_max

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    nx = 2 * ng if polarized else ng
    scf = {"x_mix": c(nx), "iteration": 5, "res_tol": 1e-7, "e_prev": -7.25,
           "mix_beta": 0.35, "mix_kind": "anderson", "wf_fp64": True,
           "evals": rng.standard_normal((nk, ns, nb)),
           "etot_history": rng.standard_normal(5),
           "rms_history": rng.random(5),
           "mag_history": (rng.standard_normal(5) if polarized
                           else np.zeros(0)),
           "mix_x": c(3, nx), "mix_f": c(3, nx)}
    return dict(rho_g=c(ng), mag_g=c(ng) if polarized else None,
                veff_g=c(ng), bz_g=c(ng) if polarized else None,
                psi=c(nk, ns, nb, ngk), band_energies=scf["evals"],
                band_occupancies=rng.random((nk, ns, nb)), scf_state=scf)


def flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def assert_same(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], str) or isinstance(fb[k], str):
            assert fa[k] == fb[k] and type(fa[k]) is type(fb[k]), k
            continue
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
        assert type(fa[k]) is type(fb[k]), k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cross_loads_are_bit_for_bit(tmp_path, kind):
    polarized = kind == "us_polarized"
    jctx = jax_context(**TINY, **KINDS[kind])
    tctx = synthetic_silicon_context(**TINY, **KINDS[kind])
    st = state_of(tctx, polarized)
    pj, pt = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jck.save_state(pj, jctx, **st)
    tck.save_state(pt, tctx, **st)
    assert jck.validate_checkpoint(pt) and tck.validate_checkpoint(pj)
    jax_of_port, port_of_jax = jck.load_state(pt, jctx), tck.load_state(pj,
                                                                       tctx)
    assert_same(jax_of_port, jck.load_state(pj, jctx))
    assert_same(port_of_jax, tck.load_state(pt, tctx))
    assert_same(jax_of_port, port_of_jax)
    np.testing.assert_array_equal(port_of_jax["rho_g"], st["rho_g"])
    np.testing.assert_array_equal(port_of_jax["scf"]["mix_f"],
                                  st["scf_state"]["mix_f"])
    import h5py

    digests = []
    for p in (pj, pt):
        with h5py.File(p, "r") as f:
            digests.append(str(f["meta"].attrs["sha256"]))
    assert digests[0] == digests[1]


def test_checkpoint_error_names_failing_field(tmp_path):
    import h5py

    ctx = synthetic_silicon_context(**TINY, ultrasoft=False)
    rho = np.ones(ctx.gvec.num_gvec, dtype=np.complex128)
    path = str(tmp_path / "state.h5")
    tck.save_state(path, ctx, rho)
    with h5py.File(path, "r+") as f:
        f["density/rho_g"][0] = 123.0 + 0j
    with pytest.raises(tck.CheckpointError, match="sha256"):
        tck.load_state(path, ctx)
    assert not tck.validate_checkpoint(path)
    tck.load_state(path, ctx, verify_checksum=False)
    tck.save_state(path, ctx, rho)
    with h5py.File(path, "r+") as f:
        f["meta"].attrs["version"] = 99
    with pytest.raises(tck.CheckpointError, match="version"):
        tck.load_state(path, ctx, verify_checksum=False)
    tck.save_state(path, ctx, rho)
    ctx2 = synthetic_silicon_context(**dict(TINY, pw_cutoff=8.0),
                                     ultrasoft=False)
    with pytest.raises(tck.CheckpointError, match="millers"):
        tck.load_state(path, ctx2)
    with pytest.raises(tck.CheckpointError, match="exist"):
        tck.load_state(str(tmp_path / "nope.h5"), ctx)
    with open(path, "r+b") as f:
        f.truncate(100)
    with pytest.raises(tck.CheckpointError, match="unreadable"):
        tck.load_state(path, ctx)


def test_interrupted_save_keeps_previous_snapshot(tmp_path):
    ctx = synthetic_silicon_context(**TINY, ultrasoft=False)
    rho1 = np.arange(ctx.gvec.num_gvec, dtype=np.complex128)
    path = str(tmp_path / "state.h5")
    tck.save_state(path, ctx, rho1)
    faults.install([("checkpoint.before_rename", 0, "raise")])
    with pytest.raises(faults.SimulatedKill):
        tck.save_state(path, ctx, 2.0 * rho1)
    faults.clear()
    np.testing.assert_array_equal(tck.load_state(path, ctx)["rho_g"], rho1)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    tck.save_state(path, ctx, 2.0 * rho1)
    np.testing.assert_array_equal(tck.load_state(path, ctx)["rho_g"],
                                  2.0 * rho1)


def test_rotation_and_find_resumable(tmp_path):
    ctx = synthetic_silicon_context(**TINY, ultrasoft=False)
    path = str(tmp_path / "auto.h5")
    base = np.ones(ctx.gvec.num_gvec, dtype=np.complex128)
    for i in range(1, 5):
        tck.save_state(path, ctx, i * base, rotate_keep=3)
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")
    assert tck.find_resumable(path, keep=3) == path
    assert jck.find_resumable(path, keep=3) == path
    assert tck.load_state(path + ".2", ctx)["rho_g"][0] == 2.0
    with open(path, "r+b") as f:
        f.truncate(64)
    assert tck.find_resumable(path, keep=3) == path + ".1"
    assert jck.find_resumable(path, keep=3) == path + ".1"
    assert tck.find_resumable(str(tmp_path / "none.h5")) is None


def strained_contexts(tmp_path, scale):
    deck = synthetic_silicon_deck(**TINY)
    deck["unit_cell"]["lattice_vectors"] = (
        np.asarray(deck["unit_cell"]["lattice_vectors"]) * scale).tolist()
    path = write_deck(str(tmp_path / f"deck{scale}"), deck,
                      synthetic_silicon_species(ultrasoft=True))
    d = os.path.dirname(path)
    return (SimulationContext.create(load_config(path), d),
            JaxContext.create(jax_load_config(path), d))


def test_miller_remap_across_strain_matches_jax(tmp_path):
    tctx, _ = strained_contexts(tmp_path, 1.0)
    sctx, sjctx = strained_contexts(tmp_path, 1.01)
    assert sctx.gvec.num_gvec != tctx.gvec.num_gvec or not np.array_equal(
        sctx.gvec.millers, tctx.gvec.millers)
    st = state_of(tctx, False, seed=3)
    path = str(tmp_path / "state.h5")
    tck.save_state(path, tctx, st["rho_g"], veff_g=st["veff_g"],
                   psi=st["psi"], scf_state=st["scf_state"])
    got, want = tck.load_state(path, sctx), jck.load_state(path, sjctx)
    assert "scf" not in got and "scf" not in want
    assert_same(got, want)
    assert got["rho_g"].shape == (sctx.gvec.num_gvec,)


def resume_run(mode, autosave=None, kill_at=None, resume=None):
    ctx = synthetic_silicon_context(**RESUME_DECK)
    ctx.cfg.control.device_scf = mode
    if autosave:
        ctx.cfg.control.autosave_every = 1
        ctx.cfg.control.autosave_path = autosave
    if kill_at is not None:
        faults.install([("scf.autosave_kill", kill_at, "raise")])
    try:
        return run_scf(ctx.cfg, ctx=ctx, device="cpu", resume=resume)
    finally:
        faults.clear()


def jax_resume_run(autosave=None, kill_at=None, resume=None):
    ctx = jax_context(**RESUME_DECK)
    ctx.cfg.control.device_scf = "off"
    if autosave:
        ctx.cfg.control.autosave_every = 1
        ctx.cfg.control.autosave_path = autosave
    if kill_at is not None:
        jax_faults.install([("scf.autosave_kill", kill_at, "raise")])
    try:
        return jax_run_scf(ctx.cfg, ctx=ctx, resume=resume,
                           devices=jax.devices()[:1])
    finally:
        jax_faults.clear()


@pytest.fixture(scope="module")
def uninterrupted():
    return {mode: resume_run(mode) for mode in ("off", "auto")}


@pytest.mark.parametrize("mode", ["off", "auto"], ids=["host", "fused"])
def test_resume_after_kill(tmp_path, uninterrupted, mode):
    full = uninterrupted[mode]
    assert full["converged"] and full["device_scf"] == (mode == "auto")
    ck = str(tmp_path / "auto.h5")
    with pytest.raises(faults.SimulatedKill):
        resume_run(mode, autosave=ck, kill_at=5)
    res = resume_run(mode, resume=ck)
    assert res["converged"]
    assert res["num_scf_iterations"] == full["num_scf_iterations"]
    if mode == "off":
        assert res["energy"]["total"] == full["energy"]["total"]
        assert res["etot_history"][6:] == full["etot_history"][6:]
    else:
        assert abs(res["energy"]["total"] - full["energy"]["total"]) < 1e-10
    # the saved history rides the resumed result from iteration 0
    assert res["etot_history"][:6] == full["etot_history"][:6]


@pytest.mark.slow
def test_resume_across_packages(tmp_path, uninterrupted):
    # ~40 s: two JAX runs beside the port's
    j_full = jax_resume_run()
    ck_j, ck_t = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    with pytest.raises(jax_faults.SimulatedKill):
        jax_resume_run(autosave=ck_j, kill_at=5)
    port_of_jax = resume_run("off", resume=ck_j)
    assert port_of_jax["converged"]
    assert abs(port_of_jax["energy"]["total"]
               - j_full["energy"]["total"]) < 1e-8
    with pytest.raises(faults.SimulatedKill):
        resume_run("off", autosave=ck_t, kill_at=5)
    jax_of_port = jax_resume_run(resume=ck_t)
    assert jax_of_port["converged"]
    assert abs(jax_of_port["energy"]["total"]
               - uninterrupted["off"]["energy"]["total"]) < 1e-8


def test_port_autosave_resumes_in_jax_first_iteration(tmp_path):
    # the fast half of the cross-package resume: a port autosave after
    # iteration 5 continues in the JAX package's host loop, whose first
    # resumed record matches the port's uninterrupted run at 1e-8 Ha
    ck = str(tmp_path / "port.h5")
    full = resume_run("off")
    with pytest.raises(faults.SimulatedKill):
        resume_run("off", autosave=ck, kill_at=5)
    ctx = jax_context(**dict(RESUME_DECK, extra_params=dict(
        RESUME_DECK["extra_params"], num_dft_iter=7)))
    ctx.cfg.control.device_scf = "off"
    j = jax_run_scf(ctx.cfg, ctx=ctx, resume=ck, devices=jax.devices()[:1])
    assert j["num_scf_iterations"] == 7
    assert abs(j["etot_history"][6] - full["etot_history"][6]) < 1e-8


def test_save_to_and_restart_from(tmp_path, uninterrupted):
    path = str(tmp_path / "final.h5")
    ctx = synthetic_silicon_context(**RESUME_DECK)
    ctx.cfg.control.device_scf = "off"
    ctx.cfg.parameters.num_dft_iter = 3
    run_scf(ctx.cfg, ctx=ctx, device="cpu", save_to=path)
    jctx = jax_context(**RESUME_DECK)
    st = jck.load_state(path, jctx)
    assert st["psi"].shape == (jctx.gkvec.num_kpoints, 1, 8,
                               jctx.gkvec.ngk_max)
    assert {"rho_g", "veff_g", "band_energies", "band_occupancies"} <= set(st)
    # a restart from the saved density converges, to the same energy
    ctx.cfg.parameters.num_dft_iter = 40
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu", restart_from=path)
    full = uninterrupted["off"]
    assert res["converged"]
    assert res["num_scf_iterations"] < full["num_scf_iterations"]
    assert abs(res["energy"]["total"] - full["energy"]["total"]) < 1e-8
