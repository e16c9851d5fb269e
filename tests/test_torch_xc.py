"""Port parity: XC_LDA_X + XC_LDA_C_PZ energies and potentials (K7 path)
against the JAX package's jax.grad values, polarized and unpolarized, on
random densities that include exactly-zero and sub-threshold (dead)
channels. Bound: 1e-12 relative, point by point."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.xc import XCFunctional as JaxXC
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels.lda_xc import lda_xc, lda_xc_unpolarized

NAMES = ["XC_LDA_X", "XC_LDA_C_PZ"]


def densities(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    nu = rng.uniform(0.0, 1.2, n) ** 3
    nd = rng.uniform(0.0, 1.2, n) ** 3
    nu[:50] = 0.0
    nd[25:75] = 0.0
    nu[100:150] = 1e-14  # below the 1e-13 dead-channel threshold
    nd[140:190] = 5e-14
    nu[200:250] = nd[200:250]  # unpolarized points
    nu[300:310] = 1e-13  # at the threshold
    return nu, nd


def assert_rel(got, want, bound=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= bound * np.abs(want)), float(np.max(err / np.maximum(np.abs(want), 1e-300)))


def test_polarized_matches_jax():
    nu, nd = densities()
    want = JaxXC(NAMES).evaluate_polarized(jnp.asarray(nu), jnp.asarray(nd))
    got = XCFunctional(NAMES).evaluate_polarized(torch.as_tensor(nu),
                                                 torch.as_tensor(nd))
    for key in ("e", "v_up", "v_dn"):
        assert_rel(got[key].numpy(), want[key])
    # dead channels carry exactly zero potential
    assert np.all(got["v_up"].numpy()[:50] == 0.0)
    assert np.all(got["v_dn"].numpy()[140:190] == 0.0)


def test_unpolarized_matches_jax():
    nu, _ = densities(seed=1)
    rho = 2.0 * nu
    want = JaxXC(NAMES).evaluate(jnp.asarray(rho))
    got = XCFunctional(NAMES).evaluate(torch.as_tensor(rho))
    assert_rel(got["e"].numpy(), want["e"])
    assert_rel(got["v"].numpy(), want["v"])


def test_unpolarized_is_the_spin_average():
    nu, _ = densities(seed=2)
    t = torch.as_tensor(nu)
    e, v = lda_xc_unpolarized(2.0 * t)
    e2, vu, vd = lda_xc(t, t)
    torch.testing.assert_close(e, e2, rtol=0, atol=0)
    torch.testing.assert_close(v, 0.5 * (vu + vd), rtol=0, atol=0)


@pytest.mark.parametrize("names", [["XC_GGA_X_PBE", "XC_GGA_C_PBE"],
                                   ["XC_LDA_X", "XC_LDA_C_PW"],
                                   ["XC_LDA_X"]])
def test_other_functionals_not_in_slice(names):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        XCFunctional(names)


def test_unknown_functional_is_an_error():
    with pytest.raises(ValueError):
        XCFunctional(["XC_NOT_A_FUNCTIONAL"])


def test_kernel_wrapper_checks_dtype():
    with pytest.raises(ValueError):
        lda_xc(torch.ones(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32))
