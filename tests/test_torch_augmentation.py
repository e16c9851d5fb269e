"""Port parity for the ultrasoft augmentation: the host tables (q_pw, q_mtrx,
the block-diagonal S integrals qmat), the augmentation charge (K4), the D
operator (K5), the beta density matrix and H/S application with Q, against
the JAX package on the small ultrasoft + symmetry deck, from numpy inputs
made with a fixed seed. On the CPU the kernel wrappers take their plain
PyTorch versions. Bounds: the host tables bit-equal; K4 and K5 1e-12
relative (the phases are reduced before the exponential, the JAX package
exponentiates the full argument); the density matrix 1e-13; H/S 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.ops import augmentation as jaug
from sirius_tpu.ops.hamiltonian import apply_h_s as jax_apply_h_s
from sirius_tpu.parallel.batched import density_matrix_kset as jax_dm_kset
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import HKSET_KEYS, hkset_from_numpy, psi_from_numpy
from sirius_tpu_torch.kernels import augmentation as kaug
from sirius_tpu_torch.ops import augmentation as taug
from sirius_tpu_torch.ops.hamiltonian import apply_h_s, make_hk_params
from sirius_tpu_torch.parallel.batched import density_matrix_kset
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context

SMALL_US = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
                ultrasoft=True, use_symmetry=True)


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def decks():
    return jax_context(**SMALL_US), port_context(**SMALL_US)


@pytest.fixture(scope="module")
def inputs(decks):
    jctx, _ = decks
    rng = np.random.default_rng(2024)
    nbeta = jctx.beta.num_beta_total
    ng = jctx.gvec.num_gvec
    a = rng.standard_normal((2, nbeta, nbeta)) + 1j * rng.standard_normal((2, nbeta, nbeta))
    dm = 0.1 * (a + np.conj(np.swapaxes(a, 1, 2)))
    veff = rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
    return dm, veff


def test_host_tables_bit_equal(decks):
    jctx, pctx = decks
    assert len(pctx.aug.per_type) == len(jctx.aug.per_type) == 1
    for jt, pt in zip(jctx.aug.per_type, pctx.aug.per_type):
        for name in ("q_pw", "xi1", "xi2", "q_mtrx"):
            np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name),
                                          err_msg=name)
    np.testing.assert_array_equal(pctx.beta.qmat, jctx.beta.qmat)
    assert np.any(pctx.beta.qmat != 0)


def test_q_pw_at_matches_jax(decks):
    jctx, pctx = decks
    t = pctx.unit_cell.atom_types[0]
    g = np.random.default_rng(3).standard_normal((50, 3))
    qmax = float(np.linalg.norm(g, axis=1).max()) + 1e-9
    want = jaug.q_pw_at(t, jaug.aug_radial_tables(t, qmax), g,
                        jctx.unit_cell.omega)
    got = taug.q_pw_at(t, taug.aug_radial_tables(t, qmax), g,
                       pctx.unit_cell.omega)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ns", [1, 2])
def test_rho_aug_matches_jax(decks, inputs, ns):
    jctx, pctx = decks
    dm = inputs[0][:ns]
    jtab = jaug.build_aug_device_tables(jctx.unit_cell, jctx.gvec, jctx.aug,
                                        jctx.beta)
    ng = jctx.gvec.num_gvec
    want_dev = np.asarray(jaug.rho_aug_g_device(jnp.asarray(dm), jtab, ng))
    want_host = np.stack([
        jaug.rho_aug_g(jctx.unit_cell, jctx.gvec, jctx.aug, [
            dm[s, off:off + nbf, off:off + nbf]
            for _, off, nbf in jctx.beta.atom_blocks(jctx.unit_cell)])
        for s in range(ns)])
    ptab = taug.build_aug_device_tables(pctx.unit_cell, pctx.gvec, pctx.aug,
                                        pctx.beta, "cpu")
    got = taug.rho_aug_g_device(torch.as_tensor(dm), ptab, ng).numpy()
    assert got.shape == (ns, ng)
    assert rel(got, want_dev) <= 1e-12
    assert rel(got, want_host) <= 1e-12


def test_d_operator_matches_jax(decks, inputs):
    jctx, pctx = decks
    veff = inputs[1]
    omega = jctx.unit_cell.omega
    jtab = jaug.build_aug_device_tables(jctx.unit_cell, jctx.gvec, jctx.aug,
                                        jctx.beta)
    want_dev = np.asarray(jaug.d_operator_device(
        jnp.asarray(veff), jnp.asarray(jctx.beta.dion), jtab, omega))
    want_host = jaug.d_operator(jctx.unit_cell, jctx.gvec, jctx.aug, veff,
                                jctx.beta)
    ptab = taug.build_aug_device_tables(pctx.unit_cell, pctx.gvec, pctx.aug,
                                        pctx.beta, "cpu")
    got = taug.d_operator_device(torch.as_tensor(veff),
                                 torch.as_tensor(pctx.beta.dion), ptab,
                                 omega).numpy()
    aug_part = want_host - jctx.beta.dion
    assert np.any(aug_part != 0)
    assert rel(got, want_dev) <= 1e-12
    assert rel(got, want_host) <= 1e-12
    # the augmentation term alone, against the host's, to the same bound
    assert rel(got - pctx.beta.dion, aug_part) <= 1e-12
    np.testing.assert_array_equal(got, got.T)


def test_augmentation_wrappers_reject_bad_input(decks):
    _, pctx = decks
    t = taug.build_aug_device_tables(pctx.unit_cell, pctx.gvec, pctx.aug,
                                     pctx.beta, "cpu")[0]
    nbeta = pctx.beta.num_beta_total
    dm = torch.zeros((1, nbeta, nbeta), dtype=torch.complex128)
    with pytest.raises(ValueError, match="dm"):
        kaug.rho_aug(dm.to(torch.complex64), t["gidx"], t["w"], t["millers"],
                     t["pos"], t["q"])
    with pytest.raises(ValueError, match="gidx"):
        kaug.rho_aug(dm, t["gidx"].long(), t["w"], t["millers"], t["pos"],
                     t["q"])
    with pytest.raises(ValueError, match="d must"):
        kaug.d_operator(torch.zeros(t["q"].shape[1], dtype=torch.complex128),
                        t["millers"], t["pos"], t["q"], t["gidx"], t["lo_idx"],
                        t["lo_mask"], 1.0, torch.zeros((nbeta, nbeta + 1),
                                                       dtype=torch.float64))


def test_density_matrix_kset_matches_jax(decks):
    jctx, _ = decks
    rng = np.random.default_rng(17)
    nk, ngk, nb = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max, 6
    beta = np.asarray(jctx.beta.beta_gk)
    psi = (rng.standard_normal((nk, 1, nb, ngk))
           + 1j * rng.standard_normal((nk, 1, nb, ngk)))
    psi *= np.asarray(jctx.gkvec.mask)[:, None, None, :]
    occ_w = rng.uniform(0.0, 0.3, (nk, 1, nb))
    re, im = jax_dm_kset(beta.real, beta.imag, psi.real, psi.imag, occ_w)
    want = np.asarray(re) + 1j * np.asarray(im)
    got = density_matrix_kset(torch.as_tensor(beta), torch.as_tensor(psi),
                              torch.as_tensor(occ_w)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-13


def test_apply_h_s_with_q_matches_jax(decks):
    jctx, pctx = decks
    rng = np.random.default_rng(23)
    dims = jctx.fft_coarse.dims
    veff = rng.uniform(-1.0, 0.5, dims)
    dmat = jctx.beta.dion + 0.05 * np.eye(jctx.beta.num_beta_total)
    jps = jax_hkset(jctx, veff, dmat, v0=0.2)
    arrays = {k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS}
    assert np.any(arrays["qmat"] != 0)
    hk = hkset_from_numpy(arrays, "cpu").hk()
    assert hk.qmat is not None
    nk, ngk, nb = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max, 5
    psi = rng.standard_normal((nk, nb, ngk)) + 1j * rng.standard_normal((nk, nb, ngk))
    hp, sp = apply_h_s(hk, psi_from_numpy(psi, "cpu"))
    for ik in range(nk):
        jh, js = jax_apply_h_s(hk_complex(hkset_slice_r(jps, ik, 0)),
                               jnp.asarray(psi[ik]))
        assert rel(hp[ik].numpy(), np.asarray(jh)) <= 1e-12
        assert rel(sp[ik].numpy(), np.asarray(js)) <= 1e-12
    # the single-k entry point carries Q too
    one = make_hk_params(pctx, 1, veff, dmat=dmat, device="cpu")
    h1, s1 = apply_h_s(one, psi_from_numpy(psi[1:2], "cpu"))
    jh, js = jax_apply_h_s(hk_complex(hkset_slice_r(jps, 1, 0)),
                           jnp.asarray(psi[1]))
    assert rel(h1[0].numpy(), np.asarray(jh)) <= 1e-12
    assert rel(s1[0].numpy(), np.asarray(js)) <= 1e-12
