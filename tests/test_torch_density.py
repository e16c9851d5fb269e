"""Port parity: the k-set density (K1 scatter, FFT, K3 accumulation), the
Fermi level and the coarse->fine density assembly against the JAX package
on the small deck. Bounds: 1e-12 relative; mu to 1e-12 Ha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import density_from_coarse_acc as jax_from_acc
from sirius_tpu.dft.occupation import find_fermi as jax_find_fermi
from sirius_tpu.parallel.batched import density_kset as jax_density_kset
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import (
    HKSET_KEYS,
    density_from_numpy,
    hkset_from_numpy,
    psi_from_numpy,
)
from sirius_tpu_torch.dft.density import (
    density_from_coarse_acc,
    grid_tables,
    initial_density_g,
)
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.kernels.density_accumulate import density_accumulate
from sirius_tpu_torch.parallel.batched import density_kset
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
             ultrasoft=False, use_symmetry=False)


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def decks():
    return jax_context(**SMALL), port_context(**SMALL)


def test_density_kset_matches_jax(decks):
    jctx, _ = decks
    rng = np.random.default_rng(8)
    nk, nb, ngk = jctx.gkvec.num_kpoints, 8, jctx.gkvec.ngk_max
    mask = np.asarray(jctx.gkvec.mask)
    psi = (rng.standard_normal((nk, 1, nb, ngk))
           + 1j * rng.standard_normal((nk, 1, nb, ngk))) * mask[:, None, None, :]
    occ_w = rng.uniform(0.0, 0.25, (nk, 1, nb))
    jps = jax_hkset(jctx, np.zeros(jctx.fft_coarse.dims))
    want = np.asarray(jax_density_kset(jps, jnp.asarray(psi.real),
                                       jnp.asarray(psi.imag), jnp.asarray(occ_w)))
    ps = hkset_from_numpy({k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS},
                          "cpu")
    got = density_kset(ps, psi_from_numpy(psi, "cpu"), torch.as_tensor(occ_w))
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= 1e-12


def test_density_from_coarse_acc_matches_jax(decks):
    jctx, pctx = decks
    rng = np.random.default_rng(9)
    acc = rng.uniform(0.0, 1.0, (1,) + tuple(jctx.fft_coarse.dims))
    want = jax_from_acc(jctx, acc)
    got = density_from_coarse_acc(pctx, torch.as_tensor(acc),
                                  grid_tables(pctx, "cpu"))
    assert rel(got.numpy(), want) <= 1e-12


def test_initial_density_identical(decks):
    from sirius_tpu.dft.density import initial_density_g as jax_initial

    jctx, pctx = decks
    want = jax_initial(jctx)
    np.testing.assert_array_equal(initial_density_g(pctx), want)
    got = density_from_numpy(want, "cpu")
    assert got.dtype == torch.complex128
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["gaussian", "fermi_dirac", "cold",
                                  "methfessel_paxton"])
def test_find_fermi_matches_jax(kind):
    rng = np.random.default_rng(10)
    ev = np.sort(rng.uniform(-0.5, 0.6, (8, 1, 8)), axis=-1)
    w = np.full(8, 1.0 / 8)
    mu_j, occ_j, ent_j = jax_find_fermi(jnp.asarray(ev), jnp.asarray(w), 8.0,
                                        0.025, kind=kind)
    mu, occ, ent = find_fermi(torch.as_tensor(ev), torch.as_tensor(w), 8.0,
                              0.025, kind=kind)
    assert abs(float(mu) - float(mu_j)) <= 1e-12
    np.testing.assert_allclose(occ.numpy(), np.asarray(occ_j), rtol=0, atol=1e-12)
    assert abs(float(ent) - float(ent_j)) <= 1e-12
    assert abs(float(torch.sum(torch.as_tensor(w)[:, None, None] * occ)) - 8.0) <= 1e-10


def test_density_accumulate_plain_sums_in_place():
    rng = np.random.default_rng(12)
    fr = torch.as_tensor(rng.standard_normal((1, 3, 10)) + 1j * rng.standard_normal((1, 3, 10)))
    occ = torch.tensor([[0.5, 0.25, 0.0]], dtype=torch.float64)
    acc = torch.ones((1, 10), dtype=torch.float64)
    out = density_accumulate(acc, fr, occ, 4.0)
    assert out is acc
    want = 1.0 + 4.0 * (0.5 * fr[0, 0].abs() ** 2 + 0.25 * fr[0, 1].abs() ** 2)
    torch.testing.assert_close(acc[0], want, rtol=1e-15, atol=0)
