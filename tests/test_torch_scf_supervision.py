"""The port's deeper band-solve retry obeys control.scf_supervision, as the
JAX package's host path does (sirius_tpu/dft/scf.py:1644: the retry runs
only under `fused is None and sup.enabled`, and sup.enabled reads
control.scf_supervision). A band_residual_blowup of 1e-30 makes every band
solve's residual unhealthy. With the flag on, both packages retry every
iteration (the port's num_loc_op_applied grows by the retry's
applications); with it off, neither does. Both packages agree in both
cases: every energy term and E_F within 1e-8 Ha, the same iteration
count. The small norm-conserving k-point deck, three iterations, with a
band-solve residual bar of 1e-13 that no band reaches: at a loose bar
the Davidson's per-band convergence mask depends on rounding, and three
iterations of an unconverged SCF then differ by ~2e-8 Ha between the
packages."""

import jax
import numpy as np
import pytest
import torch

from sirius_tpu.dft.scf import run_scf as jax_run_scf
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.dft.scf import _initial_subspace, run_scf
from sirius_tpu_torch.solvers.davidson import num_applies
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

DECK = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
            ultrasoft=False, use_symmetry=False,
            extra_params={"num_dft_iter": 3, "density_tol": 0.0,
                          "energy_tol": 0.0})


def configure(ctx, supervision):
    ctx.cfg.control.scf_supervision = supervision
    ctx.cfg.control.band_residual_blowup = 1e-30
    ctx.cfg.iterative_solver.residual_tolerance = 1e-13
    return ctx


@pytest.mark.parametrize("supervision", [True, False], ids=["on", "off"])
def test_band_retry_obeys_scf_supervision(supervision):
    jctx = configure(jax_context(**DECK), supervision)
    jctx.cfg.control.device_scf = "off"
    want = jax_run_scf(jctx.cfg, ctx=jctx, devices=jax.devices()[:1])
    ctx = configure(port_context(**DECK), supervision)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")

    nk, nb = ctx.gkvec.num_kpoints, ctx.num_bands
    steps = ctx.cfg.iterative_solver.num_steps
    # the LCAO start, then one solve per iteration, and the retry's deeper
    # solve per iteration when supervision is on
    nbig = _initial_subspace(ctx).shape[2]
    applied = nk * (nbig + 3 * num_applies(steps, nb))
    if supervision:
        applied += 3 * nk * num_applies(2 * steps, nb)
    assert res["counters"]["num_loc_op_applied"] == applied

    assert res["num_scf_iterations"] == want["num_scf_iterations"] == 3
    assert abs(res["efermi"] - want["efermi"]) <= 1e-8
    for key in res["energy"]:
        assert abs(res["energy"][key] - float(want["energy"][key])) <= 1e-8, key
    assert np.isfinite(res["energy"]["total"])
