"""Port parity for the space-group symmetrization: plane-wave coefficients
(K6, a gather over the ops with on-the-fly phases) with and without the
axial spin sign, the real-harmonic rotation matrices and the beta density
matrix, against the JAX package's host and device variants, from numpy
inputs made with a fixed seed. Two decks: the small ultrasoft cell (48
ops, half of them non-symmorphic with t = (1/4, 1/4, 1/4)) and its 2x2x2
supercell (384 ops, pure translations among them). On the CPU the K6
wrapper takes its plain PyTorch version. Bound: 1e-13 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft import density as jden
from sirius_tpu.ops.hubbard import rlm_rotation_matrix as jax_rlm
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.dft import density as tden
from sirius_tpu_torch.kernels.symmetrize_pw import symmetrize_pw as k6
from sirius_tpu_torch.ops.hubbard import rlm_rotation_matrix
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context

SMALL_US = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
                ultrasoft=True, use_symmetry=True)
DECKS = {"small_us_sym": SMALL_US,
         "supercell2": dict(SMALL_US, supercell=2)}


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=sorted(DECKS))
def decks(request):
    kw = DECKS[request.param]
    return request.param, jax_context(**kw), port_context(**kw)


def test_same_space_group(decks):
    name, jctx, pctx = decks
    want_ops = {"small_us_sym": 48, "supercell2": 384}[name]
    assert jctx.symmetry.num_ops == pctx.symmetry.num_ops == want_ops
    for jo, po in zip(jctx.symmetry.ops, pctx.symmetry.ops):
        np.testing.assert_array_equal(po.w_k, jo.w_k)
        np.testing.assert_array_equal(po.t, jo.t)
        np.testing.assert_array_equal(po.perm, jo.perm)
    ts = np.stack([op.t for op in pctx.symmetry.ops])
    assert np.any(np.abs(ts - np.rint(ts)) > 1e-12)  # non-symmorphic ops


@pytest.mark.parametrize("axial_z", [False, True], ids=["scalar", "axial"])
def test_symmetrize_pw_matches_jax(decks, axial_z):
    _, jctx, pctx = decks
    rng = np.random.default_rng(7)
    ng = jctx.gvec.num_gvec
    f = rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
    want_host = jden.symmetrize_pw(jctx, f, axial_z=axial_z)
    jtb = {k: jnp.asarray(v) for k, v in jden.build_sym_pw_tables(jctx).items()}
    want_dev = np.asarray(jden.symmetrize_pw_device(jnp.asarray(f), jtb,
                                                    axial_z=axial_z))
    tb = tden.build_sym_pw_tables(pctx, "cpu")
    got = tden.symmetrize_pw(tb, torch.as_tensor(f), axial_z=axial_z).numpy()
    assert rel(got, want_host) <= 1e-13
    assert rel(got, want_dev) <= 1e-13
    if not axial_z:
        # a symmetrized scalar field is a fixed point (the axial sign
        # det(R) R_zz is not a character of the group, so that average is
        # not a projector)
        again = tden.symmetrize_pw(tb, torch.as_tensor(got)).numpy()
        assert rel(again, got) <= 1e-13


def test_each_op_alone_and_a_wrong_rotation_is_caught(decks):
    # op by op against the JAX package's scatter table of that op alone:
    # the full group hides an inverted rotation (in diamond an op and its
    # inverse carry the same translation), a single op does not; the ops
    # taken are non-symmorphic with w_k, its transpose and its inverse
    # pairwise distinct
    _, jctx, pctx = decks
    rng = np.random.default_rng(8)
    ng = jctx.gvec.num_gvec
    f = torch.as_tensor(rng.standard_normal(ng) + 1j * rng.standard_normal(ng))
    jden.symmetrize_pw(jctx, np.zeros(ng, dtype=np.complex128))
    tb = tden.build_sym_pw_tables(pctx, "cpu")
    checked = 0
    for o, op in enumerate(pctx.symmetry.ops):
        winv = tb.rot[o].numpy()
        if (np.array_equal(op.w_k, winv) or np.array_equal(op.w_k.T, winv)
                or not np.any(np.abs(op.t) > 1e-12)):
            continue
        idx, phase, _ = jctx._sym_rot_cache[o]
        want = np.zeros(ng, dtype=np.complex128)
        np.add.at(want, idx, f.numpy() * phase)
        one = dict(millers=tb.millers, lut=tb.lut, trans=tb.trans[o:o + 1],
                   dims=tb.dims)
        got = k6(f, rot=tb.rot[o:o + 1], **one).numpy()
        assert rel(got, want) <= 1e-13
        for wrong in (op.w_k, op.w_k.T):
            r = torch.as_tensor(np.ascontiguousarray(wrong)[None], dtype=torch.int32)
            assert rel(k6(f, rot=r, **one).numpy(), want) > 1e-3
        checked += 1
        if checked == 4:
            break
    assert checked == 4


def test_rlm_rotation_matrix_matches_jax(decks):
    _, jctx, _ = decks
    for op in jctx.symmetry.ops[:12]:
        for l in range(3):
            want = jax_rlm(op.rot_cart, l)
            got = rlm_rotation_matrix(op.rot_cart, l)
            assert got.shape == (2 * l + 1, 2 * l + 1)
            assert np.max(np.abs(got - want)) <= 1e-13


@pytest.mark.parametrize("ns", [1, 2])
def test_symmetrize_density_matrix_matches_jax(decks, ns):
    _, jctx, pctx = decks
    rng = np.random.default_rng(31 + ns)
    nbeta = jctx.beta.num_beta_total
    a = rng.standard_normal((ns, nbeta, nbeta)) + 1j * rng.standard_normal((ns, nbeta, nbeta))
    dm = a + np.conj(np.swapaxes(a, 1, 2))
    if ns == 2:
        # the collinear channel swap under ops with spin_sign < 0
        assert any(op.spin_sign < 0 for op in pctx.symmetry.ops)
    want_host = jden.symmetrize_density_matrix(jctx, dm)
    jtb = {k: jnp.asarray(v) for k, v in jden.build_dm_sym_tables(jctx).items()}
    want_dev = np.asarray(jden.symmetrize_density_matrix_device(jnp.asarray(dm), jtb))
    tb = tden.build_dm_sym_tables(pctx, "cpu")
    got = tden.symmetrize_density_matrix_device(torch.as_tensor(dm), tb).numpy()
    assert rel(got, want_host) <= 1e-13
    assert rel(got, want_dev) <= 1e-13


def test_symmetrize_pw_wrapper_rejects_bad_input(decks):
    _, _, pctx = decks
    tb = tden.build_sym_pw_tables(pctx, "cpu")
    f = torch.zeros(pctx.gvec.num_gvec, dtype=torch.complex128)
    with pytest.raises(ValueError, match="f must"):
        k6(f.to(torch.complex64), tb.millers, tb.lut, tb.rot, tb.trans, tb.dims)
    with pytest.raises(ValueError, match="rot"):
        k6(f, tb.millers, tb.lut, tb.rot.long(), tb.trans, tb.dims)
    with pytest.raises(ValueError, match="lut"):
        k6(f, tb.millers, tb.lut[:-1], tb.rot, tb.trans, tb.dims)
