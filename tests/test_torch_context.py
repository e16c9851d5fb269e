"""Port parity: the host tables of sirius_tpu_torch's SimulationContext
against the JAX package's, on the small deck and on the full-width 2-atom
deck (norm-conserving, no symmetry), and the ultrasoft species' S
integrals. Host numpy code ported by copy must
give bit-equal tables; where jnp became numpy the bound is 1e-14 relative."""

import jax.numpy as jnp
import numpy as np
import pytest

from sirius_tpu.core.sbessel import spherical_jn_jax
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import context_arrays
from sirius_tpu_torch.core.sbessel import spherical_jn_recurrence
from sirius_tpu_torch.dft.scf import check_context
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context

DECKS = {
    "small": dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8),
    "full_width_2atom": dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2)),
}


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_context_tables_bit_equal(deck):
    kw = dict(ultrasoft=False, use_symmetry=False, **DECKS[deck])
    want = context_arrays(jax_context(**kw))
    got = context_arrays(port_context(**kw))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_context_shapes_of_the_decks():
    small = port_context(ultrasoft=False, use_symmetry=False, **DECKS["small"])
    assert small.gkvec.num_kpoints == 8
    assert small.num_bands == 8
    assert small.fft_coarse.dims == (16, 16, 16)
    assert small.gvec.fft.dims == (20, 20, 20)
    assert small.gkvec.ngk_max == 120


def test_kpoints_and_weights():
    ctx = port_context(ultrasoft=False, use_symmetry=False, **DECKS["small"])
    assert ctx.gkvec.num_kpoints == 8
    np.testing.assert_allclose(np.sum(ctx.kweights), 1.0, rtol=0, atol=1e-15)


def test_spherical_jn_recurrence_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-40.0, 40.0, 2000), [0.0, 1e-6, -1e-5, 3e-4]])
    want = np.asarray(spherical_jn_jax(6, jnp.asarray(x)))
    got = spherical_jn_recurrence(6, x)
    scale = np.maximum(np.abs(want), 1e-300)
    assert np.max(np.abs(got - want) / scale * (np.abs(want) > 1e-200)) <= 1e-14


def test_ultrasoft_species_raise():
    # ultrasoft species build: the augmentation tables and the block-diagonal
    # S integrals are there, equal to the JAX package's; a PAW species is
    # still refused where the SCF checks its context
    kw = dict(ultrasoft=True, use_symmetry=False, **DECKS["small"])
    ctx = port_context(**kw)
    assert ctx.aug is not None and ctx.aug.per_type[0] is not None
    nbeta = ctx.beta.num_beta_total
    assert ctx.beta.qmat.shape == (nbeta, nbeta)
    assert np.any(ctx.beta.qmat != 0)
    np.testing.assert_array_equal(ctx.beta.qmat, jax_context(**kw).beta.qmat)
    ctx.unit_cell.atom_types[0].pseudo_type = "PAW"
    with pytest.raises(NotImplementedError, match="PAW"):
        check_context(ctx.cfg, ctx)
