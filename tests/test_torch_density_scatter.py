"""K16 and K18's plain versions against the JAX package, and the wrappers'
contracts on the CPU.

- K16 (kernels/density_scatter.py): density_scatter, as
  dft/density.py::density_from_coarse_acc calls it, against the JAX
  package's density_from_coarse_acc (the math FusedScf._step_impl traces:
  1/Omega, r_to_g, the coarse -> fine scatter) at 1e-14 relative, on 1
  and 2 spin channels of the US deck and the 4 fields of a spinor run's
  shape; on the CPU the wrapper is its plain version bit for bit, and its
  table puts every coarse G on its fine slot, -1 elsewhere (a table that
  is not one-to-one raises).
- K18 (kernels/h_diag.py): compute_h_diag against the JAX package's
  compute_h_diag_device at 1e-14 relative, with projectors and without;
  masked lanes are 1e4; v0 as a 0-d tensor or a float; bad shapes raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import density_from_coarse_acc as jax_density
from sirius_tpu.parallel.batched import compute_h_diag_device
from sirius_tpu_torch.dft.density import density_from_coarse_acc, grid_tables
from sirius_tpu_torch.kernels import density_scatter as k16
from sirius_tpu_torch.kernels import h_diag as k18
from sirius_tpu_torch.parallel.batched import compute_h_diag
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      threads_per_test_worker)

torch.set_num_threads(threads_per_test_worker())

DECK = dict(gk_cutoff=3.0, pw_cutoff=9.0, ngridk=(2, 2, 2), num_bands=8,
            ultrasoft=True, use_symmetry=False)


@pytest.fixture(scope="module")
def ctx():
    return synthetic_silicon_context(**DECK)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("ns", [1, 2, 4])
def test_density_scatter_matches_jax(ctx, ns):
    rng = np.random.default_rng(ns)
    acc = rng.random((ns,) + tuple(ctx.fft_coarse.dims))
    tables = grid_tables(ctx, "cpu")
    got = density_from_coarse_acc(ctx, torch.as_tensor(acc), tables).numpy()
    want = jax_density(ctx, acc)
    assert got.shape == want.shape == (ns, ctx.gvec.num_gvec)
    assert rel(got, want) <= 1e-14
    # the coarse sphere lands on its fine slots and nowhere else
    outside = np.setdiff1d(np.arange(ctx.gvec.num_gvec), ctx.coarse_to_fine)
    assert outside.size and np.all(got[:, outside] == 0)
    # the wrapper is its plain version on the CPU, bit for bit
    plain = k16.density_scatter_plain(torch.as_tensor(acc), tables.omega,
                                      tables.fine_to_coarse_box,
                                      ctx.gvec.num_gvec).numpy()
    assert plain.tobytes() == got.tobytes()


def test_fine_to_coarse_box_table(ctx):
    table = k16.fine_to_coarse_box(ctx.gvec_coarse.fft_index,
                                   ctx.coarse_to_fine, ctx.gvec.num_gvec)
    assert table.dtype == np.int32
    assert np.array_equal(table[ctx.coarse_to_fine],
                          ctx.gvec_coarse.fft_index)
    assert np.sum(table >= 0) == len(ctx.coarse_to_fine)
    with pytest.raises(ValueError, match="two coarse G"):
        k16.fine_to_coarse_box([0, 1], [3, 3], 5)
    with pytest.raises(ValueError, match="fine set"):
        k16.fine_to_coarse_box([0, 1], [3, 5], 5)
    with pytest.raises(ValueError, match="int32"):
        k16.density_scatter(torch.zeros((1, 2, 2, 2), dtype=torch.float64),
                            1.0, torch.zeros(5, dtype=torch.int64), 5)


def h_inputs(ctx, ns, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.asarray(ctx.gkvec.mask, dtype=np.float64)
    ekin = np.asarray(ctx.gkvec.kinetic())
    beta = np.asarray(ctx.beta.beta_gk) * mask[:, None, :]
    nbeta = beta.shape[1]
    d = rng.standard_normal((ns, nbeta, nbeta))
    return ekin, mask, beta, d + d.transpose(0, 2, 1), float(rng.random())


@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("projectors", [True, False])
def test_h_diag_matches_jax(ctx, ns, projectors):
    ekin, mask, beta, d, v0 = h_inputs(ctx, ns)
    if not projectors:
        beta = beta[:, :0]
        d = d[:, :0, :0]
    t = torch.as_tensor
    got = compute_h_diag(t(ekin), t(mask), t(beta), t(d).to(torch.complex128),
                         t(v0, dtype=torch.float64)).numpy()
    want = np.asarray(compute_h_diag_device(
        jnp.asarray(ekin), jnp.asarray(mask), jnp.asarray(beta.real),
        jnp.asarray(beta.imag), jnp.asarray(d), jnp.asarray(v0)))
    assert got.shape == want.shape == (ekin.shape[0], ns, ekin.shape[1])
    assert rel(got, want) <= 1e-14
    assert np.all(got[np.broadcast_to(mask[:, None, :] == 0, got.shape)]
                  == 1e4)
    # v0 as a host float gives the same bits
    again = compute_h_diag(t(ekin), t(mask), t(beta),
                           t(d).to(torch.complex128), v0).numpy()
    assert again.tobytes() == got.tobytes()


def test_h_diag_pass_checks_its_inputs():
    ekin = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        k18.h_diag_pass(ekin.float(), ekin, None, 0.0, 1)
    with pytest.raises(ValueError, match="mask"):
        k18.h_diag_pass(ekin, ekin[:, :4], None, 0.0, 1)
    with pytest.raises(ValueError, match="q must be"):
        k18.h_diag_pass(ekin, ekin, torch.zeros((2, 2, 5)), 0.0, 2)
    with pytest.raises(ValueError, match="v0 must be"):
        k18.h_diag_pass(ekin, ekin, None, torch.tensor(0.5), 1)
    out = k18.h_diag_pass(ekin + 1.0, torch.ones_like(ekin), None,
                          torch.tensor(0.5, dtype=torch.float64), 3)
    assert out.shape == (2, 3, 5) and torch.all(out == 1.5)
