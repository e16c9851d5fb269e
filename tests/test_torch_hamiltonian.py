"""Port parity: H*psi and S*psi (K1 path: masked scatter, cuFFT, the K1c
potential multiply, gather fused with the kinetic term) and the G<->r
transforms against the JAX package, complex128, on the small deck. On the
CPU the wrappers take the kernels' plain PyTorch versions. Bound: 1e-12
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.core import fftgrid as jfft
from sirius_tpu.ops.hamiltonian import apply_h_s as jax_apply_h_s
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import HKSET_KEYS, hkset_from_numpy, psi_from_numpy
from sirius_tpu_torch.core import fftgrid as tfft
from sirius_tpu_torch.kernels.local_hpsi import box_to_pw_hpsi, pw_to_box
from sirius_tpu_torch.kernels.veff_multiply import veff_multiply
from sirius_tpu_torch.ops.hamiltonian import apply_h_s, make_hk_params
from sirius_tpu_torch.parallel.batched import make_hkset_params
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
             ultrasoft=False, use_symmetry=False)


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def setup():
    jctx = jax_context(**SMALL)
    rng = np.random.default_rng(11)
    dims = jctx.fft_coarse.dims
    veff = rng.uniform(-1.0, 0.5, dims)
    jps = jax_hkset(jctx, veff, v0=0.3)
    arrays = {k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS}
    return jctx, jps, arrays, rng


@pytest.mark.parametrize("garbage", [False, True], ids=["masked", "garbage"])
def test_apply_h_s_matches_jax(setup, garbage):
    jctx, jps, arrays, rng = setup
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    nb = 6
    psi = rng.standard_normal((nk, nb, ngk)) + 1j * rng.standard_normal((nk, nb, ngk))
    mask = np.asarray(jctx.gkvec.mask)
    if not garbage:
        psi = psi * mask[:, None, :]
    else:
        # padded lanes carry non-zero values and all point at box slot 0,
        # the G=0 slot: the masked scatter must leave psi(G=0) intact
        assert np.any(mask == 0)
        assert np.all(jctx.gkvec.fft_index[mask == 0] == 0)
    hk = hkset_from_numpy(arrays, "cpu").hk()
    hp, sp = apply_h_s(hk, psi_from_numpy(psi, "cpu"))
    for ik in range(nk):
        prm = hk_complex(hkset_slice_r(jps, ik, 0))
        jh, js = jax_apply_h_s(prm, jnp.asarray(psi[ik]))
        assert rel(hp[ik].numpy(), np.asarray(jh)) <= 1e-12
        assert rel(sp[ik].numpy(), np.asarray(js)) <= 1e-12


def test_make_hk_params_single_k(setup):
    jctx, jps, _, rng = setup
    pctx = port_context(**SMALL)
    ik = 3
    veff = np.asarray(jps.veff_r[0])
    hk = make_hk_params(pctx, ik, veff, device="cpu")
    psi = (rng.standard_normal((5, jctx.gkvec.ngk_max))
           + 1j * rng.standard_normal((5, jctx.gkvec.ngk_max)))
    hp, _ = apply_h_s(hk, psi_from_numpy(psi[None], "cpu"))
    jh, _ = jax_apply_h_s(hk_complex(hkset_slice_r(jps, ik, 0)), jnp.asarray(psi))
    assert rel(hp[0].numpy(), np.asarray(jh)) <= 1e-12


@pytest.mark.parametrize("v0_kind", ["float", "tensor"])
def test_make_hkset_params_matches_jax(setup, v0_kind):
    # the preconditioner diagonal (computed on tensors, v0 a float or the
    # 0-d tensor veff(G=0) the SCF loop passes) and the masked projectors
    jctx, jps, arrays, _ = setup
    v0 = 0.3 if v0_kind == "float" else torch.tensor(0.3, dtype=torch.float64)
    ps = make_hkset_params(port_context(**SMALL), np.asarray(jps.veff_r[0]),
                           v0=v0, device="cpu")
    assert rel(ps.h_diag.numpy(), arrays["h_diag"]) <= 1e-12
    np.testing.assert_array_equal(ps.o_diag.numpy(), arrays["o_diag"])
    mask = arrays["mask"][:, None, :]
    beta = (arrays["beta_re"] + 1j * arrays["beta_im"]) * mask
    assert rel(ps.beta.numpy(), beta) <= 1e-12
    assert np.all(ps.beta.numpy()[np.broadcast_to(mask, beta.shape) == 0] == 0)


def test_pw_to_box_keeps_g0_slot():
    # lane 0 is G=0 (box slot 0); lanes 3, 4 are padding pointing at slot 0
    psi = torch.tensor([[[5.0 + 1j, 2.0, 3.0, 99.0, -7.0]]], dtype=torch.complex128)
    idx = torch.tensor([[0, 5, 2, 0, 0]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0]], dtype=torch.float64)
    box = pw_to_box(psi, idx, mask, 8)
    want = torch.zeros(8, dtype=torch.complex128)
    want[0], want[5], want[2] = 5.0 + 1j, 2.0, 3.0
    assert torch.equal(box[0, 0], want)
    hp, sp = box_to_pw_hpsi(box, psi, torch.full((1, 5), 2.0, dtype=torch.float64),
                            mask, idx)
    assert torch.equal(sp[0, 0], psi[0, 0] * mask[0])
    assert torch.equal(hp[0, 0], (2.0 * psi[0, 0] + box[0, 0, idx[0].long()]) * mask[0])


def test_g_to_r_r_to_g_match_jax():
    jctx = jax_context(**SMALL)
    rng = np.random.default_rng(5)
    ng = jctx.gvec.num_gvec
    dims = jctx.gvec.fft.dims
    idx = np.asarray(jctx.gvec.fft_index)
    c = rng.standard_normal((2, ng)) + 1j * rng.standard_normal((2, ng))
    want_r = np.asarray(jfft.g_to_r(jnp.asarray(c), jnp.asarray(idx), dims))
    got_r = tfft.g_to_r(torch.as_tensor(c), torch.as_tensor(idx), dims).numpy()
    assert rel(got_r, want_r) <= 1e-12
    want_g = np.asarray(jfft.r_to_g(jnp.asarray(want_r), jnp.asarray(idx), dims))
    got_g = tfft.r_to_g(torch.tensor(want_r), torch.as_tensor(idx), dims).numpy()
    assert rel(got_g, want_g) <= 1e-12


def test_kernel_wrappers_reject_bad_input():
    # complex64 blocks are K1's fp32 instantiation; a real block, or a
    # complex64 block with a float64 mask, is no instantiation
    psi = torch.zeros((1, 2, 4), dtype=torch.complex64)
    idx = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        pw_to_box(psi.real, idx, None, 8)
    with pytest.raises(ValueError):
        pw_to_box(psi, idx, torch.ones((1, 4), dtype=torch.float64), 8)
    assert pw_to_box(psi, idx, None, 8).dtype == torch.complex64
    with pytest.raises(TypeError):
        pw_to_box(psi.to(torch.complex128), idx.long(), None, 8)
    with pytest.raises(ValueError):
        pw_to_box(psi.to(torch.complex128), torch.zeros((3,), dtype=torch.int32),
                  None, 8)


def test_hkset_with_ultrasoft_q_raises(setup):
    # a non-zero Q is carried (S psi = psi + beta Q <beta|psi>); a
    # spin-polarized k-set, once refused, is a batch of (k, spin) entries
    _, _, arrays, rng = setup
    us = dict(arrays)
    nbeta = arrays["qmat"].shape[0]
    us["qmat"] = np.eye(nbeta)
    ps = hkset_from_numpy(us, "cpu")
    assert ps.qmat is not None and ps.qmat.dtype == torch.complex128
    np.testing.assert_array_equal(ps.qmat.numpy(), np.eye(nbeta))
    assert hkset_from_numpy(arrays, "cpu").qmat is None
    nk, ngk = arrays["mask"].shape
    psi = rng.standard_normal((nk, 3, ngk)) + 1j * rng.standard_normal((nk, 3, ngk))
    psi = psi * arrays["mask"][:, None, :]
    _, sp = apply_h_s(ps.hk(), psi_from_numpy(psi, "cpu"))
    beta = ps.beta.numpy()
    want = psi + np.einsum("kxg,kbx->kbg", beta,
                           np.einsum("kxg,kbg->kbx", beta.conj(), psi))
    assert rel(sp.numpy(), want) <= 1e-12
    ps.veff_r = torch.cat([ps.veff_r, ps.veff_r])
    ps.dion = torch.cat([ps.dion, 2.0 * ps.dion])
    hk = ps.hk()
    # batch entry b = ik * 2 + ispn: the k tables of ik, the D of ispn
    assert hk.ekin.shape[0] == 2 * nk
    for b in range(2 * nk):
        assert torch.equal(hk.beta[b], ps.beta[b // 2])
        assert torch.equal(hk.fft_index[b], ps.fft_index[b // 2])
        assert torch.equal(hk.dion[b], ps.dion[b % 2])
    psi2 = psi_from_numpy(np.repeat(psi, 2, axis=0), "cpu")
    _, sp2 = apply_h_s(hk, psi2)
    assert rel(sp2.numpy()[::2], want) <= 1e-12
    assert rel(sp2.numpy()[1::2], want) <= 1e-12


@pytest.mark.parametrize("ns", [1, 2])
def test_veff_multiply_plain_matches_jax_product(ns):
    # K1c's plain version is the JAX package's fr * veff_r with batch entry
    # b = ik * ns + ispn taking the potential of its spin
    rng = np.random.default_rng(40 + ns)
    nk, r, n = 3, 4, 60
    fr = rng.standard_normal((nk * ns, r, n)) + 1j * rng.standard_normal((nk * ns, r, n))
    veff = rng.standard_normal((ns, n))
    want = fr * np.tile(veff, (nk, 1))[:, None, :]
    got = veff_multiply(torch.as_tensor(fr), torch.as_tensor(veff))
    np.testing.assert_array_equal(got.numpy(), want)
    assert veff_multiply.launches == 0
    with pytest.raises(ValueError):
        veff_multiply(torch.as_tensor(fr), torch.as_tensor(veff[:, :-1]))
    with pytest.raises(ValueError):
        veff_multiply(torch.as_tensor(fr).to(torch.complex64),
                      torch.as_tensor(veff))


def test_hkset_with_index_outside_the_box_raises(setup):
    _, _, arrays, _ = setup
    bad = dict(arrays)
    bad["fft_index"] = arrays["fft_index"].copy()
    bad["fft_index"][0, 0] = int(np.prod(arrays["veff_r"].shape[-3:]))
    with pytest.raises(ValueError, match="outside"):
        hkset_from_numpy(bad, "cpu")
