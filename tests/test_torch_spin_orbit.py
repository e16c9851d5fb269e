"""Port parity: spin-orbit coupling on the spinor path (ops/so.py, a copy
of the JAX package's, wired into dft/scf_nc.py). The species is the
synthetic one with its l = 1 beta split into j = 1/2 and 3/2
(sirius_tpu_torch/testing.py::synthetic_silicon_species(spin_orbit=True)),
read by both packages from the deck and UPF file that
tools/torch_port_reference.py::write_deck_files writes (the JAX package's
synthetic context takes no j-resolved species):

- the completeness identity of tests/test_spin_orbit.py
  (test_degenerate_j_reduces_to_plain_sigma_b) on the port's d_blocks;
- f_coefficients, d_blocks, q_blocks and rotate_dm against the JAX
  package's on the norm-conserving and the ultrasoft SO decks, from seeded
  random D, B and density-matrix inputs: 1e-14 relative to the largest
  magnitude of each output;
- run_scf on the two SO decks ("so_nc": no symmetry; "so_us_sym": four
  augmentation channels and the magnetic space group) against the JAX
  package's records (sirius_tpu_torch/data/jax_reference.json, a fixed 20
  iterations past convergence): every energy term within 1e-8 Ha, every
  moment component within 1e-6, the same iteration count;
- ROADMAP queue 3 item 15, a fault shared with the JAX package: a
  collinear deck ignores so_correction (only the non-collinear driver
  reads it), so the port's energies with the key on and off are equal,
  and a j-resolved species without spin-orbit gives the JAX numbers.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from sirius_tpu.config.schema import load_config as jax_load_config
from sirius_tpu.context import SimulationContext as JaxContext
from sirius_tpu.dft.scf import run_scf as jax_run_scf
from sirius_tpu.ops import so as jso
from sirius_tpu_torch.config.schema import load_config
from sirius_tpu_torch.context import SimulationContext
from sirius_tpu_torch.dft.scf import band_solve_path, run_scf
from sirius_tpu_torch.ops import so
from sirius_tpu_torch.ops.spinor import spin_blocks_from_components
from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                      synthetic_silicon_species,
                                      threads_per_test_worker, write_deck)

torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
SO_DECKS = ("so_nc", "so_us_sym")


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference",
        os.path.join(ROOT, "tools", "torch_port_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Each SO deck's path, written once for both packages."""
    tool = reference_tool()
    assert set(SO_DECKS) == set(tool.FILE_DECKS)
    return {name: tool.write_deck_files(name,
                                        str(tmp_path_factory.mktemp(name)))
            for name in SO_DECKS}


def contexts(path):
    d = os.path.dirname(path)
    return (JaxContext.create(jax_load_config(path), d),
            SimulationContext.create(load_config(path), d))


def test_degenerate_j_reduces_to_plain_sigma_b():
    # both j = l +- 1/2 channels on one radial function and one dion value:
    # sum_j P_lj = 1, so the Eq. 19 blocks contracted over the duplicated
    # radial structure are the plain sigma.B assembly (+ the ionic 0.7)
    class B:
        def __init__(self, l, j):
            self.l, self.j = l, j

    class T:
        spin_orbit = True
        beta = [B(1, 0.5), B(1, 1.5)]
        d_ion = np.array([[0.7, 0.0], [0.0, 0.7]])

    t = T()
    f = so.f_coefficients(t)
    nm = 3
    nbf = 2 * nm
    meta = [(ib, b.l, b.j) for ib, b in enumerate(t.beta)
            for _ in range(2 * b.l + 1)]
    same_rf = np.array([[a[0] == b_[0] for b_ in meta] for a in meta])
    same_lj = np.array([[a[1:] == b_[1:] for b_ in meta] for a in meta])
    rf = np.asarray([m[0] for m in meta])
    data = so.SpinOrbitData(
        f_by_type=[f], frf_by_type=[f * same_rf[:, :, None, None]],
        dion_xi=[t.d_ion[np.ix_(rf, rf)] * same_lj],
        dion_collinear=[np.zeros((nbf, nbf))], qxi_by_type=[None],
        blocks=[(0, 0, nbf)], type_of_atom=np.array([0]))
    rng = np.random.default_rng(5)

    def sym(n):
        a = rng.standard_normal((n, n))
        return 0.5 * (a + a.T)

    a_plain = sym(nm)
    b_plain = [sym(nm) for _ in range(3)]
    out = data.d_blocks(np.kron(np.ones((2, 2)), a_plain),
                        [np.kron(np.ones((2, 2)), b) for b in b_plain])
    eff = out.reshape(4, 2, nm, 2, nm).sum(axis=(1, 3))
    plain = spin_blocks_from_components(
        *(torch.as_tensor(x) for x in (a_plain, b_plain[2], b_plain[0],
                                       b_plain[1]))).numpy()
    plain[0] += 0.7 * np.eye(nm)
    plain[1] += 0.7 * np.eye(nm)
    np.testing.assert_allclose(eff, plain, atol=1e-12)


@pytest.mark.parametrize("name", SO_DECKS)
def test_spin_orbit_blocks_match_jax(decks, name):
    jctx, pctx = contexts(decks[name])
    t = pctx.unit_cell.atom_types[0]
    assert t.spin_orbit and [(b.l, b.j) for b in t.beta] == [
        (0, 0.5), (1, 0.5), (1, 1.5)]
    assert rel(so.f_coefficients(t),
               jso.f_coefficients(jctx.unit_cell.atom_types[0])) <= 1e-14
    ours, theirs = so.SpinOrbitData.build(pctx), jso.SpinOrbitData.build(jctx)
    nbeta = pctx.beta.num_beta_total
    assert nbeta == jctx.beta.num_beta_total == 14
    rng = np.random.default_rng(7)

    def sym(scale):
        a = scale * rng.standard_normal((nbeta, nbeta))
        return a + a.T

    d0 = np.asarray(pctx.beta.dion) + sym(0.1)
    db = [sym(0.05) for _ in range(3)]
    for args in ((d0, db), (np.asarray(pctx.beta.dion), [None] * 3)):
        assert rel(ours.d_blocks(*args), theirs.d_blocks(*args)) <= 1e-14
    q = ours.q_blocks()
    if pctx.aug is None:
        assert q is None and theirs.q_blocks() is None
    else:
        assert rel(q, theirs.q_blocks()) <= 1e-14
    dm = (rng.standard_normal((3, nbeta, nbeta))
          + 1j * rng.standard_normal((3, nbeta, nbeta)))
    dm[:2] = dm[:2] + dm[:2].conj().transpose(0, 2, 1)
    assert rel(ours.rotate_dm(dm), theirs.rotate_dm(dm)) <= 1e-14


@pytest.mark.parametrize("name", SO_DECKS)
def test_spin_orbit_scf_matches_jax_record(decks, name):
    with open(REF_PATH) as f:
        ref = json.load(f)["decks"][name]
    assert ref["deck"]["so_correction"] and ref["deck"]["spin_orbit"]
    path = decks[name]
    cfg = load_config(path)
    ctx = SimulationContext.create(cfg, os.path.dirname(path))
    assert band_solve_path(cfg, ctx) == "kset_nc"
    assert ctx.symmetry is None or ctx.symmetry.num_ops == ref[
        "num_symmetry_ops"]
    res = run_scf(cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == ref["num_scf_iterations"] == 20
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    assert abs(res["efermi"] - ref["efermi"]) <= 1e-8
    got = np.concatenate([np.ravel(res["magnetisation"]["total"]),
                          np.ravel(res["magnetisation"]["atoms"])])
    want = np.concatenate([np.ravel(ref["magnetisation"]["total"]),
                           np.ravel(ref["magnetisation"]["atoms"])])
    assert np.max(np.abs(got - want)) <= 1e-6
    # the state is magnetic: spin-orbit acts on a real moment
    assert np.linalg.norm(want[:3]) > 1.0
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10


def test_spin_orbit_changes_the_spinor_result(decks):
    # the same deck without so_correction lands elsewhere: the D and Q
    # blocks of the spin-orbit path are in use
    with open(REF_PATH) as f:
        ref = json.load(f)["decks"]["so_us_sym"]
    path = decks["so_us_sym"]
    cfg = load_config(path)
    cfg.parameters.so_correction = False
    cfg.parameters.num_dft_iter = 3
    res = run_scf(cfg, device="cpu", base_dir=os.path.dirname(path))
    assert abs(res["energy"]["total"] - ref["energy"]["total"]) > 1e-4


def collinear_deck(tmp_path, num_dft_iter: int) -> str:
    """A Gamma-only collinear (num_mag_dims 1, +0.5 / +0.5) deck of the
    j-resolved ultrasoft species with the space group, run for a fixed
    count (to a tolerance the stop moves by an iteration with rounding)."""
    params = {"num_mag_dims": 1, "num_dft_iter": num_dft_iter,
              "density_tol": 0.0, "energy_tol": 0.0}
    deck = synthetic_silicon_deck(
        gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8,
        use_symmetry=True, extra_params=params,
        moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]]))
    return write_deck(str(tmp_path), deck, synthetic_silicon_species(
        ultrasoft=True, spin_orbit=True), fmt="upf")


def test_collinear_deck_ignores_so_correction(tmp_path):
    # ROADMAP queue 3 item 15: num_mag_dims 1 never reads the key, in the
    # JAX package (only scf_nc.py:116 does) and in the port
    path = collinear_deck(tmp_path, 4)
    runs = {}
    for flag in (False, True):
        cfg = load_config(path)
        cfg.parameters.so_correction = flag
        runs[flag] = run_scf(cfg, device="cpu", base_dir=str(tmp_path))
    assert runs[True]["energy"] == runs[False]["energy"]
    assert runs[True]["etot_history"] == runs[False]["etot_history"]


def test_j_resolved_species_without_spin_orbit_matches_jax(tmp_path):
    path = collinear_deck(tmp_path, 24)
    got = run_scf(load_config(path), device="cpu", base_dir=str(tmp_path))
    cfg = jax_load_config(path)
    cfg.control.device_scf = "off"
    want = jax_run_scf(cfg, str(tmp_path), devices=jax.devices()[:1])
    assert got["num_scf_iterations"] == want["num_scf_iterations"] == 24
    for key, value in want["energy"].items():
        assert abs(got["energy"][key] - value) <= 1e-8, key
    assert abs(got["magnetisation"]["total"][2]
               - want["magnetisation"]["total"][2]) <= 1e-6
