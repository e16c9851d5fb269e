"""SCF supervision and recovery in the port (dft/recovery.py, dft/scf.py)
against the JAX package's, driven by fault injection (utils/faults.py).

The port's versions of tests/test_recovery.py, on the k-set deck (ngridk
2x2x2, which fuses; the JAX tests' 1-k deck takes the Gamma path on one
device): a NaN density, potential or band energies rolls the run back and
it converges to the unperturbed energy within 1e-8 Ha; three NaNs climb
the ladder to the host loop; an exhausted budget aborts with the
diagnostic (and its JSON dump); supervision off raises at once; a flagged
band stagnation takes the deeper retry; the early warning snapshots the
fused carry ahead of the cadence; a forecast misfire costs no recovery; a
device OOM takes the first rung of the OOM ladder that applies (the host
loop on the fused deck, the chunked projectors on a single-k deck, abort
where none applies); a lost device escapes. The exact-diagonalization
rescue of the JAX package's serial_bands path is not ported (ROADMAP
queue 1 item 9).

Against the JAX package: the same fault plan gives the same ladder_history
(sentinel, action, rung, rolled_back_to, iteration) and energies within
1e-8 Ha, on the host loop and on the fused step; the same residual and
energy sequences fed to both packages' ScfSupervisor fire the same
sentinels and directives; utils/devfail.classify gives the JAX package's
class on every injected text (both packages') and "oom" on
torch.cuda.OutOfMemoryError; apply_oom_hint degrades alike.
"""

import json

import jax
import numpy as np
import pytest
import torch

from sirius_tpu.dft import recovery as jrec
from sirius_tpu.dft.scf import run_scf as jax_run_scf
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu.utils import devfail as jdevfail
from sirius_tpu.utils import faults as jax_faults
from sirius_tpu_torch.dft.recovery import LADDER, ScfAbortError, ScfSupervisor
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      threads_per_test_worker)
from sirius_tpu_torch.utils import devfail, faults

torch.set_num_threads(threads_per_test_worker())

DECK = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
            ultrasoft=True, use_symmetry=False,
            extra_params={"num_dft_iter": 40, "density_tol": 5e-9,
                          "energy_tol": 1e-10})
# the JAX tests' deck: one k-point, the Gamma path, chunk-eligible
GAMMA_DECK = dict(DECK, ngridk=(1, 1, 1))


@pytest.fixture(autouse=True)
def no_fault_plans():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def run(device_scf="off", plan=None, deck=None, iters=None, **ctl):
    ctx = synthetic_silicon_context(**(deck or DECK))
    ctx.cfg.control.device_scf = device_scf
    if iters:
        ctx.cfg.parameters.num_dft_iter = iters
    for k, v in ctl.items():
        setattr(ctx.cfg.control, k, v)
    faults.install(plan or [])
    return run_scf(ctx.cfg, ctx=ctx, device="cpu")


def jax_run(device_scf="off", plan=None, deck=None, iters=None):
    ctx = jax_context(**(deck or DECK))
    ctx.cfg.control.device_scf = device_scf
    if iters:
        ctx.cfg.parameters.num_dft_iter = iters
    jax_faults.install(plan or [])
    return jax_run_scf(ctx.cfg, ctx=ctx, devices=jax.devices()[:1])


def ladder(res):
    return [(h["sentinel"], h["action"], h["rung"], h["rolled_back_to"],
             h["iteration"]) for h in res["recovery"]["ladder_history"]]


@pytest.fixture(scope="module")
def e_ref():
    r = run("off")
    assert r["converged"] and r["recovery"]["recoveries"] == 0
    assert r["recovery"]["ladder_history"] == []
    assert "scf::band_solve" in r["timers"]
    return r["energy"]["total"]


def test_nan_density_recovers_host(e_ref):
    r = run("off", plan=[("scf.density", 3, "nan")])
    assert r["converged"]
    rec = r["recovery"]
    assert rec["recoveries"] == 1
    assert rec["ladder_history"][0]["action"] == "flush_history"
    assert rec["ladder_history"][0]["sentinel"] == "nonfinite_fields"
    assert rec["ladder_history"][0]["rolled_back_to"] == 2
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_nan_density_recovers_fused(e_ref):
    r = run("auto", plan=[("scf.density", 3, "nan")])
    assert r["converged"] and r["device_scf"]
    rec = r["recovery"]
    assert rec["recoveries"] == 1
    assert rec["ladder_history"][0]["sentinel"] == "device_nonfinite"
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


@pytest.mark.parametrize("site,sentinel", [
    ("scf.potential", "potential_nonfinite"),
    ("scf.evals", "nonfinite_fields")])
def test_nan_field_recovers_host(e_ref, site, sentinel):
    r = run("off", plan=[(site, 2, "nan")])
    assert r["converged"]
    assert ladder(r)[0][:2] == (sentinel, "flush_history")
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_ladder_escalates_to_host_fallback(e_ref):
    r = run("auto", iters=120, plan=[("scf.density", i, "nan")
                                     for i in (4, 7, 10)])
    assert r["converged"]
    assert not r["device_scf"]  # the rest of the run on the host loop
    rec = r["recovery"]
    assert rec["recoveries"] == 3
    assert [h["action"] for h in rec["ladder_history"]] == list(LADDER[:3])
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_abort_carries_diagnostic(tmp_path):
    dump = tmp_path / "diag.json"
    with pytest.raises(ScfAbortError) as ei:
        run("off", plan=[("scf.density", 2, "nan"), ("scf.density", 4, "nan")],
            max_recoveries=1, diag_dump=str(dump))
    diag = ei.value.diagnostic
    assert diag["sentinel"] == "nonfinite_fields"
    assert diag["recoveries"] == 1
    assert diag["last_good_iteration"] is not None
    assert isinstance(ei.value, FloatingPointError)
    on_disk = json.loads(dump.read_text())
    assert on_disk["sentinel"] == "nonfinite_fields"
    assert on_disk["ladder_history"]


@pytest.mark.parametrize("mode,site", [("off", "scf.density"),
                                       ("off", "scf.potential"),
                                       ("auto", "scf.density")])
def test_supervision_off_restores_fatal_behaviour(mode, site):
    with pytest.raises(FloatingPointError, match="non-finite"):
        run(mode, plan=[(site, 2, "nan")], scf_supervision=False)


def test_band_stagnate_deep_retry(e_ref):
    base = run("off", iters=3)
    r = run("off", iters=3, plan=[("scf.band_stagnate", 2, "flag")])
    assert ("scf.band_stagnate", 2, "flag") in faults.fired()
    assert (r["counters"]["num_loc_op_applied"]
            > base["counters"]["num_loc_op_applied"])
    full = run("off", plan=[("scf.band_stagnate", 2, "flag")])
    assert full["converged"]
    assert abs(full["energy"]["total"] - e_ref) < 1e-8


def test_proactive_snapshot_beats_cadence_fused(e_ref):
    # the warning is 1.0 while the forecaster has fewer than 3 samples, so
    # the fused step snapshots at it = 1 beside the cadence's it = 0
    r = run("auto", plan=[("scf.density", 3, "nan")], snapshot_every=5)
    assert r["converged"]
    assert r["recovery"]["ladder_history"][0]["rolled_back_to"] == 1
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_forecast_misfire_costs_no_recovery(e_ref):
    r = run("off", plan=[("scf.forecast_misfire", 4, "flag")])
    assert ("scf.forecast_misfire", 4, "flag") in faults.fired()
    assert r["converged"]
    assert r["recovery"]["recoveries"] == 0
    assert r["forecast"]["warnings_total"] >= 1
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_device_oom_on_the_fused_deck_leaves_the_fused_step(e_ref):
    r = run("auto", plan=[("device.oom", 2, "raise")])
    assert r["converged"] and not r["device_scf"]
    assert ladder(r)[0][:2] == ("device_oom", "disable_device_scf")
    assert r["recovery"]["ladder_history"][0]["ladder"] == "oom"
    assert abs(r["energy"]["total"] - e_ref) < 1e-8


def test_device_oom_without_a_rung_aborts():
    # a multi-k host-loop run has no memory plan to change
    with pytest.raises(ScfAbortError, match="device_oom"):
        run("off", plan=[("device.oom", 1, "raise")])


def test_device_oom_on_a_single_k_deck_engages_chunked_projectors():
    from sirius_tpu_torch.kernels import beta_chunk as k9
    from sirius_tpu_torch.ops import beta_chunked

    base = run("off", deck=GAMMA_DECK)
    calls = beta_chunked.apply_h_s_chunked.calls
    r = run("off", deck=GAMMA_DECK, plan=[("device.oom", 2, "raise")])
    assert beta_chunked.apply_h_s_chunked.calls > calls
    assert ladder(r)[0][:2] == ("device_oom", "shrink_beta_budget")
    assert r["converged"]
    assert abs(r["energy"]["total"] - base["energy"]["total"]) < 1e-8
    assert k9.beta_chunk.launches == 0  # the CPU runs the plain version


def test_device_lost_escapes():
    with pytest.raises(RuntimeError) as ei:
        run("off", plan=[("device.lost", 1, "raise")])
    assert devfail.classify(ei.value) == "device_lost"


@pytest.mark.parametrize("mode,plan,iters", [
    pytest.param("off", [("scf.density", 3, "nan")], None,
                 marks=pytest.mark.slow),
    ("auto", [("scf.density", 3, "nan")], None),
    pytest.param("off", [("scf.potential", 2, "nan"),
                         ("scf.evals", 5, "nan")], None,
                 marks=pytest.mark.slow),
], ids=["host-density", "fused-density", "host-potential-evals"])
def test_same_plan_same_ladder_as_jax(mode, plan, iters):
    # the host cases are slow (~20 s: the JAX package's host loop)
    got = run(mode, plan=plan, iters=iters)
    want = jax_run(mode, plan=plan, iters=iters)
    assert ladder(got) == ladder(want)
    assert got["num_scf_iterations"] == want["num_scf_iterations"]
    assert abs(got["energy"]["total"] - float(want["energy"]["total"])) < 1e-8


@pytest.mark.slow
@pytest.mark.parametrize("plan", [
    [("scf.density", i, "nan") for i in (4, 7, 10)],
    [("device.oom", 2, "raise")]], ids=["three-nans", "oom"])
def test_fused_escalation_matches_jax(plan):
    # ~30 s a case: the 120-iteration budget in both packages
    got = run("auto", plan=plan, iters=120)
    want = jax_run("auto", plan=plan, iters=120)
    assert ladder(got) == ladder(want)
    assert abs(got["energy"]["total"] - float(want["energy"]["total"])) < 1e-8


class Ctl:
    scf_supervision = True
    max_recoveries = 3
    rms_divergence_iters = 4
    energy_blowup_tol = 1e4
    diag_dump = ""
    forecast_backoff_iters = 3


SEQUENCES = {
    "contraction": [(1e-2 * 0.5 ** i, -1.0 - 1e-3 * i) for i in range(12)],
    "non_monotone": [(r, -1.0) for r in (1e-3, 2e-3, 1.5e-3, 2.5e-3, 2e-3,
                                         3e-3)],
    "growth": [(1e-4 * 3.0 ** i, -1.0) for i in range(8)],
    "blowup": [(1e-3, -1.0), (1e-3, 2e4), (1e-3, 2e4)],
    "nan": [(1e-3, -1.0), (float("nan"), float("nan")), (1e-3, -1.0)],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("forecast", [True, False])
def test_sentinels_match_jax(seq, forecast):
    ctl = Ctl()
    ctl.forecast_enabled = forecast
    mine = ScfSupervisor(ctl, 0.7, "anderson", density_tol=1e-9)
    ref = jrec.ScfSupervisor(ctl, 0.7, "anderson", density_tol=1e-9)
    got, want = [], []
    for it, (rms, e) in enumerate(SEQUENCES[seq]):
        got.append((mine.observe(it, rms, e), mine.should_snapshot()))
        want.append((ref.observe(it, rms, e), ref.should_snapshot()))
    assert got == want
    a, b = mine.forecast_snapshot(), ref.forecast_snapshot()
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


STATES = [
    {"device_scf": True, "beta_chunked": False, "beta_chunk_eligible": False},
    {"device_scf": False, "beta_chunked": False, "beta_chunk_eligible": True,
     "beta_chunk_can_halve": True},
    {"device_scf": True, "beta_chunked": True, "beta_chunk_eligible": True,
     "beta_chunk_can_halve": False},
]


@pytest.mark.parametrize("state", range(len(STATES)))
def test_directives_match_jax(state):
    sentinels = ["device_oom", "device_nonfinite", "device_oom",
                 "rms_divergence", "device_oom"]
    mine = ScfSupervisor(Ctl(), 0.6, "anderson")
    ref = jrec.ScfSupervisor(Ctl(), 0.6, "anderson")
    for s in (mine, ref):
        s.snapshot(0, {"x_mix": np.zeros(3)})
    for it, sentinel in enumerate(sentinels):
        outs = []
        for s, err in ((mine, ScfAbortError), (ref, jrec.ScfAbortError)):
            try:
                outs.append(vars(s.recover(sentinel, it,
                                           state=dict(STATES[state]))))
            except err as e:
                outs.append(("abort", e.diagnostic["sentinel"],
                             e.diagnostic["recoveries"]))
        assert outs[0] == outs[1], (it, sentinel)
    assert mine.history == ref.history


TEXTS = {
    "jax_oom": jax_faults._DEVICE_ERRORS["device.oom"],
    "jax_lost": jax_faults._DEVICE_ERRORS["device.lost"],
    "port_oom": faults._DEVICE_ERRORS["device.oom"],
    "port_lost": faults._DEVICE_ERRORS["device.lost"],
    "transient": "UNAVAILABLE: connection reset by peer",
    "bug": "index 3 is out of bounds for dimension 0",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_devfail_classifies_as_jax(name):
    # the injected texts of both packages take the same class; the port's
    # CUDA texts are its own (the JAX package's markers are the TPU's)
    err = RuntimeError(TEXTS[name])
    want = {"jax_oom": "oom", "port_oom": "oom",
            "jax_lost": "device_lost", "port_lost": "device_lost",
            "transient": "transient", "bug": None}[name]
    assert devfail.classify(err) == want
    if not name.startswith("port_"):
        assert jdevfail.classify(err) == want


@pytest.mark.parametrize("text,cls", [
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "oom"),
    ("CUDA error: an illegal memory access was encountered", "device_lost"),
    ("CUDA error: unspecified launch failure", "device_lost"),
    ("NCCL communicator was aborted", "transient"),
])
def test_devfail_classifies_cuda_errors(text, cls):
    assert devfail.classify(RuntimeError(text)) == cls
    if cls == "oom":
        assert devfail.classify(torch.cuda.OutOfMemoryError(text)) == "oom"
    # a wrapped error classifies through its cause
    try:
        try:
            raise RuntimeError(text)
        except RuntimeError as inner:
            raise ValueError("while launching") from inner
    except ValueError as outer:
        assert devfail.classify(outer) == cls
    assert devfail.classify(None) is None


@pytest.mark.parametrize("level", [1, 2, 3])
def test_apply_oom_hint_matches_jax(level):
    ctx, jctx = synthetic_silicon_context(**DECK), jax_context(**DECK)
    got = devfail.apply_oom_hint(ctx.cfg.control, level)
    want = jdevfail.apply_oom_hint(jctx.cfg.control, level)
    assert got == want
    for key in ("beta_chunk_budget_bytes", "beta_chunk_size", "beta_chunked",
                "device_scf"):
        assert getattr(ctx.cfg.control, key) == getattr(jctx.cfg.control, key)


def test_fault_plans_parse_as_jax():
    env = "scf.density@3:nan,scf.autosave_kill@5:raise*2,device.oom"
    faults.load_env(env)
    jax_faults.load_env(env)
    assert ([vars(s) for s in faults._plan]
            == [vars(s) for s in jax_faults._plan])
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    x = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.complex128)
    faults.install([("scf.density", 0, "nan")])
    y = faults.corrupt("scf.density", 0, x)
    assert torch.isnan(y.real[0]) and x[0] == 0 and y.device == x.device
    assert faults.corrupt("scf.density", 0, x) is x  # fired once
