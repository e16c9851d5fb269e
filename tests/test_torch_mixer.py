"""Port parity: the density mixer (dft/mixer.py) against the JAX package's
Mixer over four steps of a seeded sequence of output densities, for the
charge-only vector and the two-component [rho; m] vector of a collinear
run, linear and Anderson, with and without the Hartree metric. Compared:
each step's mixed vector, rms and residual Hartree energy. Bound: 1e-12
relative. anderson_stable and broyden2 likewise over six steps (the
history fills and rolls), with and without passive trailing entries
(extra_len), and an SCF with each on the small ultrasoft deck with the
space group against the JAX package's records (every energy term within
1e-8 Ha, the same iteration count). The fused step's device mixer
(dft/mixer.py::DeviceMixer, kernels/mixer.py's plain version on the CPU)
against the JAX package's device_mix, linear and Anderson, 1 and 2
components, at every history count from 0 to max_history + 3 (the ring
wrapped), and with a NaN in a history row and in x_new: x_mixed, rms and
eha within 1e-12 relative, the same fallback choice."""

import json
import os

import numpy as np
import pytest
import torch

from sirius_tpu.config.schema import Config as JaxConfig
from sirius_tpu.dft.mixer import DeviceMixerState
from sirius_tpu.dft.mixer import Mixer as JaxMixer
from sirius_tpu.dft.mixer import (device_mix, device_mixer_init,
                                  device_mixer_weights)
from sirius_tpu_torch.config.schema import Config
from sirius_tpu_torch.dft.mixer import DeviceMixer, Mixer
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


DEVICE_M = 4  # max_history of the device-mixer cases: 8 steps wrap it


def device_mixers(kind, components, hartree=True):
    rng = np.random.default_rng(45)
    glen2 = np.sort(rng.uniform(0.0, 20.0, NG))
    glen2[0] = 0.0
    mixer_cfg = {"type": kind, "beta": 0.6, "max_history": DEVICE_M,
                 "use_hartree": hartree}
    jm = JaxMixer(JaxConfig.from_dict({"mixer": mixer_cfg}).mixer, glen2,
                  num_components=components, omega=OMEGA)
    pm = Mixer(Config.from_dict({"mixer": mixer_cfg}).mixer, glen2, OMEGA,
               device="cpu", num_components=components)
    return rng, jm, DeviceMixer(pm, components * NG)


def jax_device_mix(state, x, out, jm):
    import jax.numpy as jnp

    state, mixed, rms, eha = device_mix(
        state, jnp.asarray(x), jnp.asarray(out), device_mixer_weights(jm),
        jm.beta, jm.kind, jm.max_history)
    return state, np.array(mixed), float(rms), float(eha)


def same(a, b):
    """Equal NaN masks, and the finite entries within 1e-12 relative."""
    ok = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), ok)
    scale = max(np.max(np.abs(b[ok]), initial=0.0), 1e-300)
    assert np.max(np.abs(a[ok] - b[ok]), initial=0.0) <= 1e-12 * scale


@pytest.mark.parametrize("components", [1, 2])
@pytest.mark.parametrize("kind", ["linear", "anderson"])
def test_device_mix_matches_jax(kind, components):
    # 8 steps: the history counts 0, 1, ..., 7 = DEVICE_M + 3, the ring
    # wrapping at the fifth
    rng, jm, dm = device_mixers(kind, components)
    size = components * NG
    state = device_mixer_init(size, DEVICE_M)
    x = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    for step in range(DEVICE_M + 4):
        assert dm.count == min(step, DEVICE_M)
        out = 0.5 * x + 0.1 * (rng.standard_normal(size)
                               + 1j * rng.standard_normal(size))
        state, want, rms, eha = jax_device_mix(state, x, out, jm)
        got, grms, geha = dm.mix(torch.as_tensor(x), torch.as_tensor(out))
        same(got.numpy(), want)
        assert abs(float(grms) - rms) <= 1e-12 * rms
        assert abs(float(geha) - eha) <= 1e-12 * eha
        # the history, oldest first, is the JAX package's block
        hx, hf = dm.history()
        m = int(state.count)
        same(hx.numpy(), np.asarray(state.hx_re)[:m]
             + 1j * np.asarray(state.hx_im)[:m])
        same(hf.numpy(), np.asarray(state.hf_re)[:m]
             + 1j * np.asarray(state.hf_im)[:m])
        x = want


@pytest.mark.parametrize("case", ["nan_history_row", "nan_x_new",
                                  "inf_history_x"])
def test_device_mix_fallbacks_match_jax(case):
    # three steps of history, then the poisoned step: a NaN residual row
    # (a and b not finite: a := I, g = 0, the damped step), a NaN in x_new
    # (likewise, with the NaN carried into x_mixed) and an infinite input
    # row (a finite system whose x_opt is not: the damped-step fallback)
    import jax.numpy as jnp

    rng, jm, dm = device_mixers("anderson", 2)
    size = 2 * NG
    state = device_mixer_init(size, DEVICE_M)
    x = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    for _ in range(3):
        out = 0.5 * x + 0.1 * (rng.standard_normal(size)
                               + 1j * rng.standard_normal(size))
        dm.mix(torch.as_tensor(x), torch.as_tensor(out))
        state, x, _, _ = jax_device_mix(state, x, out, jm)
    out = 0.5 * x + 0.1 * (rng.standard_normal(size)
                           + 1j * rng.standard_normal(size))
    hx_re, hf_re = np.asarray(state.hx_re).copy(), np.asarray(state.hf_re).copy()
    if case == "nan_history_row":
        hf_re[1, 7] = np.nan
        dm.hf[1, 7] = complex(np.nan, float(state.hf_im[1, 7]))
    elif case == "nan_x_new":
        out[11] = np.nan
    else:
        hx_re[2, 5] = np.inf
        dm.hx[2, 5] = complex(np.inf, float(state.hx_im[2, 5]))
    state = DeviceMixerState(jnp.asarray(hx_re), state.hx_im,
                             jnp.asarray(hf_re), state.hf_im, state.count)
    _, want, rms, eha = jax_device_mix(state, x, out, jm)
    got, grms, geha = dm.mix(torch.as_tensor(x), torch.as_tensor(out))
    same(got.numpy(), want)
    # the fallback: x_in + beta (x_new - x_in) wherever x_mixed is finite
    damped = x + jm.beta * (out - x)
    ok = np.isfinite(damped)
    assert np.max(np.abs(want[ok] - damped[ok])) <= 1e-12 * np.max(
        np.abs(damped[ok]))
    for g, w in ((float(grms), rms), (float(geha), eha)):
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-12 * abs(w)


def test_device_mixer_refuses_a_long_history():
    mixer_cfg = {"type": "anderson", "max_history": 65}
    pm = Mixer(Config.from_dict({"mixer": mixer_cfg}).mixer,
               np.linspace(0.0, 4.0, 10), OMEGA, device="cpu")
    with pytest.raises(ValueError, match="max_history"):
        DeviceMixer(pm, 10)
