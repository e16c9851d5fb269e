"""Port parity: the file entry points. dft/scf.py::run_scf_from_file and
the sirius-scf-torch CLI (cli.py) on decks written into tmp_path
(sirius_tpu_torch/testing.py::write_deck, species as JSON and as UPF) at
the small shape (gk 3 / pw 7, 2x2x2, 8 bands), norm-conserving and
ultrasoft with the space group:

- run_scf_from_file(device="cpu") against the JAX package's
  run_scf(cfg, base_dir, devices=jax.devices()[:1]) on the same deck: every
  energy term within 1e-8 Ha, the same iteration count; the species are
  resolved against the deck's directory, not the working directory;
- output.json: the JAX package's run_scf_from_file on the same deck fixes
  the schema; every key of its ground_state is in the port's but for those
  of modules still to port (LATER, each with its ROADMAP queue 1 item);
- test_against: 0 and TEST PASSED against the JAX package's output.json,
  1, TEST FAILED and the stderr line against a copy whose total is 1e-4
  off; a reference with forces switches them on;
- the CLI: exit 0 on the CPU, 2 on a missing input, 2 naming the ROADMAP
  item for each task the port does not run yet; processing_unit "cpu" in
  the deck picks the CPU, any other deck the GPU (which raises here);
- the kernel headers are package data: every #include "..." under
  sirius_tpu_torch/csrc/ is matched by pyproject.toml's package-data."""

import copy
import fnmatch
import json
import os
import re
import tomllib

import jax
import numpy as np
import pytest
import torch

from sirius_tpu.config.schema import load_config as jax_load_config
from sirius_tpu.dft.scf import run_scf as jax_run_scf
from sirius_tpu.dft.scf import run_scf_from_file as jax_run_scf_from_file
from sirius_tpu_torch import cli
from sirius_tpu_torch.dft.scf import UNPORTED_TASKS, run_scf_from_file
from sirius_tpu_torch.testing import (synthetic_silicon_deck,
                                      synthetic_silicon_species,
                                      threads_per_test_worker, write_deck)

torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
KINDS = {"nc": dict(ultrasoft=False, use_symmetry=False),
         "us_sym": dict(ultrasoft=True, use_symmetry=True)}
# keys of the JAX package's ground_state that come with modules still to
# port, and the ROADMAP queue 1 item of each
LATER = {"gshard_devices": 10, "recovery": 6, "timers": 12, "forecast": 12,
         "numerics": 12}


def write(directory, kind, fmt="json", **params):
    spec = dict(KINDS[kind])
    ultrasoft = spec.pop("ultrasoft")
    deck = synthetic_silicon_deck(**SMALL, **spec,
                                  extra_params={**TIGHT, **params})
    return write_deck(str(directory), deck,
                      synthetic_silicon_species(ultrasoft=ultrasoft), fmt)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The JAX package's run_scf on each kind's JSON deck, on one device."""
    out = {}
    for kind in KINDS:
        d = tmp_path_factory.mktemp("jax_" + kind)
        path = write(d, kind)
        out[kind] = jax_run_scf(jax_load_config(path), str(d),
                                devices=jax.devices()[:1])
    return out


@pytest.fixture(scope="module")
def jax_output(tmp_path_factory):
    """output.json of the JAX package's run_scf_from_file on the ultrasoft
    deck (written in its working directory)."""
    d = tmp_path_factory.mktemp("jax_file")
    path = write(d / "deck", "us_sym")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert jax_run_scf_from_file(path) == 0
    finally:
        os.chdir(cwd)
    with open(d / "output.json") as f:
        return json.load(f), str(d / "output.json")


def run_port(tmp_path, monkeypatch, kind, fmt="json", **kw):
    """run_scf_from_file on the CPU from a working directory that is not the
    deck's; returns (rc, output.json)."""
    path = write(tmp_path / "deck", kind, fmt)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    rc = run_scf_from_file(path, device="cpu", **kw)
    with open(run_dir / "output.json") as f:
        return rc, json.load(f)


@pytest.mark.parametrize("fmt", ["json", "upf"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_run_scf_from_file_matches_jax(tmp_path, monkeypatch, jax_results,
                                       kind, fmt):
    rc, out = run_port(tmp_path, monkeypatch, kind, fmt)
    assert rc == 0
    got, want = out["ground_state"], jax_results[kind]
    assert got["num_scf_iterations"] == want["num_scf_iterations"]
    assert got["converged"] and want["converged"]
    assert sorted(got["energy"]) == sorted(want["energy"])
    for key, value in want["energy"].items():
        assert abs(got["energy"][key] - value) <= 1e-8, key
    assert abs(got["efermi"] - want["efermi"]) <= 1e-8
    assert out["task"] == "ground_state_new"
    assert not os.path.exists(tmp_path / "run" / "sirius.h5")


def test_output_json_has_the_jax_schema(tmp_path, monkeypatch, jax_output):
    ref, _ = jax_output
    rc, out = run_port(tmp_path, monkeypatch, "us_sym")
    assert rc == 0
    assert sorted(out) == sorted(ref) == ["comm_world_size", "config",
                                          "git_hash", "ground_state", "task"]
    missing = set(ref["ground_state"]) - set(out["ground_state"])
    assert missing <= set(LATER), missing - set(LATER)
    assert sorted(out["config"]) == sorted(ref["config"])
    assert "_state" not in out["ground_state"]


def test_test_against_passes_and_fails(tmp_path, monkeypatch, capsys,
                                       jax_output):
    ref, ref_path = jax_output
    rc, _ = run_port(tmp_path / "a", monkeypatch, "us_sym",
                     test_against=ref_path)
    assert rc == 0
    assert "TEST PASSED" in capsys.readouterr().out
    off = copy.deepcopy(ref)
    off["ground_state"]["energy"]["total"] += 1e-4
    off_path = tmp_path / "off.json"
    off_path.write_text(json.dumps(off))
    rc, _ = run_port(tmp_path / "b", monkeypatch, "us_sym",
                     test_against=str(off_path))
    assert rc == 1
    cap = capsys.readouterr()
    assert "TEST FAILED" in cap.out
    assert "test_against FAILED: |dE_total|=1.000e-04" in cap.err


def test_reference_forces_switch_them_on(tmp_path, monkeypatch, capsys,
                                         jax_output):
    # the atoms sit on the diamond sites: the forces vanish by symmetry
    ref, _ = jax_output
    with_forces = copy.deepcopy(ref)
    with_forces["ground_state"]["forces"] = [[0.0, 0.0, 0.0]] * 2
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(with_forces))
    rc, out = run_port(tmp_path, monkeypatch, "us_sym",
                       test_against=str(path))
    assert rc == 0
    assert out["config"]["control"]["print_forces"]
    assert np.max(np.abs(out["ground_state"]["forces"])) < 1e-5
    assert "|dF|_max vs reference" in capsys.readouterr().out


def test_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    path = write(tmp_path / "deck", "nc", num_dft_iter=2)
    monkeypatch.chdir(tmp_path)
    assert cli.main([path, "--device", "cpu"]) == 0
    with open(tmp_path / "output.json") as f:
        assert json.load(f)["ground_state"]["num_scf_iterations"] == 2


def test_cli_picks_the_device_from_the_deck(tmp_path, monkeypatch):
    cpu = write(tmp_path / "cpu", "nc", num_dft_iter=1)
    with open(cpu) as f:
        deck = json.load(f)
    deck["control"] = {"processing_unit": "cpu"}
    with open(cpu, "w") as f:
        json.dump(deck, f)
    gpu = write(tmp_path / "gpu", "nc", num_dft_iter=1)
    assert cli.deck_device(cpu) == "cpu" and cli.deck_device(gpu) == "cuda"
    monkeypatch.chdir(tmp_path)
    assert cli.main([cpu]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([gpu])


def test_cli_missing_input_exits_2(tmp_path, capsys):
    assert cli.main([str(tmp_path / "absent.json")]) == 2
    assert "input file not found" in capsys.readouterr().err


@pytest.mark.parametrize("task", sorted(UNPORTED_TASKS))
def test_unported_tasks_name_their_item(tmp_path, monkeypatch, capsys, task):
    path = write(tmp_path, "nc")
    monkeypatch.chdir(tmp_path)
    assert cli.main([path, "--device", "cpu", "--task", task]) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP queue 1, item {UNPORTED_TASKS[task]}" in err
    assert not os.path.exists(tmp_path / "output.json")
    with pytest.raises(NotImplementedError, match=task):
        run_scf_from_file(path, task=task, device="cpu")


def test_kernel_headers_are_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "sirius_tpu_torch"]
    csrc = os.path.join(ROOT, "sirius_tpu_torch", "csrc")
    included = set()
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            included.update(re.findall(r'#include\s+"([^"]+)"', f.read()))
    assert included, "no local includes found"
    for name in sorted(included | set(os.listdir(csrc))):
        assert os.path.exists(os.path.join(csrc, name)), name
        assert any(fnmatch.fnmatch("csrc/" + name, g) for g in globs), name
