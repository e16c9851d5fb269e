"""Port parity: the density mixer (dft/mixer.py) against the JAX package's
Mixer over four steps of a seeded sequence of output densities, for the
charge-only vector and the two-component [rho; m] vector of a collinear
run, linear and Anderson, with and without the Hartree metric. Compared:
each step's mixed vector, rms and residual Hartree energy. Bound: 1e-12
relative. anderson_stable and broyden2 likewise over six steps (the
history fills and rolls), with and without passive trailing entries
(extra_len), and an SCF with each on the small ultrasoft deck with the
space group against the JAX package's records (every energy term within
1e-8 Ha, the same iteration count)."""

import json
import os

import numpy as np
import pytest
import torch

from sirius_tpu.config.schema import Config as JaxConfig
from sirius_tpu.dft.mixer import Mixer as JaxMixer
from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.dft.mixer import Mixer
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      threads_per_test_worker)

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

NG = 300
OMEGA = 270.0


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("components", [1, 2])
@pytest.mark.parametrize("kind,hartree", [("linear", False),
                                          ("anderson", False),
                                          ("anderson", True),
                                          ("broyden1", True)])
def test_mixer_matches_jax(components, kind, hartree):
    rng = np.random.default_rng(41)
    glen2 = np.sort(rng.uniform(0.0, 20.0, NG))
    glen2[0] = 0.0
    mixer_cfg = {"type": kind, "beta": 0.6, "max_history": 3,
                 "use_hartree": hartree}
    jm = JaxMixer(JaxConfig.from_dict({"mixer": mixer_cfg}).mixer, glen2,
                  num_components=components, omega=OMEGA)
    pm = Mixer(Config.from_dict({"mixer": mixer_cfg}).mixer, glen2, OMEGA,
               device="cpu", num_components=components)
    size = components * NG
    x = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    xt = torch.as_tensor(x)
    for _ in range(4):
        # a contracting fixed-point map with noise: the residual shrinks
        out = 0.5 * x + 0.1 * (rng.standard_normal(size)
                               + 1j * rng.standard_normal(size))
        assert abs(pm.rms(xt, torch.as_tensor(out)) - jm.rms(x, out)) \
            <= 1e-12 * jm.rms(x, out)
        x_next = jm.mix(x, out)
        xt = pm.mix(xt, torch.as_tensor(out))
        assert rel(xt.numpy(), x_next) <= 1e-12
        want = jm.residual_hartree_energy(x_next, out)
        got = pm.residual_hartree_energy(xt, torch.as_tensor(out))
        assert abs(got - want) <= 1e-12 * abs(want)
        x = x_next


@pytest.mark.parametrize("extra_len", [0, 17])
@pytest.mark.parametrize("components", [1, 2])
@pytest.mark.parametrize("hartree", [False, True])
@pytest.mark.parametrize("kind", ["anderson_stable", "broyden2"])
def test_quasi_newton_mixers_match_jax(kind, hartree, components, extra_len):
    rng = np.random.default_rng(43)
    glen2 = np.sort(rng.uniform(0.0, 20.0, NG))
    glen2[0] = 0.0
    mixer_cfg = {"type": kind, "beta": 0.6, "max_history": 3,
                 "use_hartree": hartree}
    jm = JaxMixer(JaxConfig.from_dict({"mixer": mixer_cfg}).mixer, glen2,
                  num_components=components, extra_len=extra_len,
                  omega=OMEGA)
    pm = Mixer(Config.from_dict({"mixer": mixer_cfg}).mixer, glen2, OMEGA,
               device="cpu", num_components=components, extra_len=extra_len)
    size = components * NG + extra_len
    x = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    xt = torch.as_tensor(x)
    for _ in range(6):
        out = 0.5 * x + 0.1 * (rng.standard_normal(size)
                               + 1j * rng.standard_normal(size))
        # the passive entries move, yet steer neither the rms nor the mix
        assert abs(pm.rms(xt, torch.as_tensor(out)) - jm.rms(x, out)) \
            <= 1e-12 * jm.rms(x, out)
        x_next = jm.mix(x, out)
        xt = pm.mix(xt, torch.as_tensor(out))
        assert rel(xt.numpy(), x_next) <= 1e-12
        want = jm.residual_hartree_energy(x_next, out)
        got = pm.residual_hartree_energy(xt, torch.as_tensor(out))
        assert abs(got - want) <= 1e-12 * abs(want)
        x = x_next


@pytest.mark.parametrize("kind", ["anderson_stable", "broyden2"])
def test_scf_with_quasi_newton_mixers_matches_jax_record(kind):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sirius_tpu_torch", "data",
        "jax_reference.json")
    with open(path) as f:
        ref = json.load(f)["decks"]["small_us_sym_" + kind]
    assert ref["deck"]["control"] == {"mixer.type": kind}
    ctx = synthetic_silicon_context(
        gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
        ultrasoft=True, use_symmetry=True,
        extra_params={"num_dft_iter": 40, "density_tol": 5e-9,
                      "energy_tol": 1e-10})
    ctx.cfg.mixer.type = kind
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == ref["num_scf_iterations"]
    assert res["converged"] == ref["converged"]
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
