"""Port parity: the meta-GGA tau machinery (ops/mgga.py with K11a / K11b,
K1c and K3 on their plain versions) against the JAX package's
sirius_tpu/ops/mgga.py on the small deck: H*psi with the tau term
(norm-conserving, one spin; ultrasoft with two spin channels, batch entry
ik * 2 + ispn), the kinetic-energy density tau_kset, and the mGGA band
solve from the same start block. Inputs are made with numpy from a seed
and fed to both packages; v_tau and the G+k vectors cross through
convert.mgga_from_numpy. Bounds: H*psi and tau 1e-12 relative to the
largest magnitude; the band solve's converged eigenvalues and residuals
and its lowest two bands' projector 1e-10 (40 steps).
Also the JAX tests' identities: a constant v_tau gives c x the kinetic
diagonal (tests/test_mgga.py:73-96) and Omega tau(G = 0) is the kinetic
energy (:99-122); and tau per spin under the spin-flip ops of an
antiferromagnetic group, symmetrized as the JAX package does (1e-13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import density_from_coarse_acc as jax_from_acc
from sirius_tpu.dft.density import symmetrize_pw as jax_symmetrize_pw
from sirius_tpu.ops import mgga as jax_mgga
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.parallel.batched import split_cplx
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import (HKSET_KEYS, hkset_from_numpy,
                                      mgga_from_numpy, psi_from_numpy)
from sirius_tpu_torch.dft.density import (build_sym_pw_tables,
                                          density_from_coarse_acc, grid_tables,
                                          initial_density_g,
                                          initial_magnetization_g,
                                          symmetrize_pw, symmetrize_tau)
from sirius_tpu_torch.kernels import mgga_tau as k11
from sirius_tpu_torch.ops.hamiltonian import apply_h_s
from sirius_tpu_torch.ops.mgga import (apply_h_s_mgga, davidson_kset_mgga,
                                       tau_kset)
from sirius_tpu_torch.parallel.batched import make_hkset_params
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
DECKS = {
    "nc": dict(SMALL, ultrasoft=False, use_symmetry=False),
    "us_spin": dict(SMALL, ultrasoft=True, use_symmetry=False,
                    moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]),
                    extra_params={"num_mag_dims": 1}),
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def make_deck(name, seed=11):
    """The JAX context and HkSetParams with a random potential and a random
    positive v_tau per spin, and the port's parameters from the same
    arrays."""
    jctx = jax_context(**DECKS[name])
    ns = jctx.num_spins
    rng = np.random.default_rng(seed)
    dims = tuple(jctx.fft_coarse.dims)
    veff = rng.uniform(-1.0, 0.5, (ns,) + dims)
    vtau = rng.uniform(0.05, 0.4, (ns,) + dims)
    jps = jax_hkset(jctx, veff, v0=0.3)
    arrays = {k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS}
    return jctx, jps, hkset_from_numpy(arrays, "cpu"), vtau, rng


@pytest.fixture(scope="module", params=sorted(DECKS))
def deck(request):
    return make_deck(request.param)


def random_block(rng, shape, mask=None):
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return psi if mask is None else psi * mask


@pytest.mark.parametrize("garbage", [False, True], ids=["masked", "garbage"])
def test_apply_h_s_mgga_matches_jax(deck, garbage):
    jctx, jps, ps, vtau, rng = deck
    nk, ns, ngk = jctx.gkvec.num_kpoints, jctx.num_spins, jctx.gkvec.ngk_max
    nb = 5
    mask = np.asarray(jctx.gkvec.mask)
    # batch entry ik * ns + ispn; padded lanes carry non-zero values in the
    # garbage case and point at box slot 0, the G = 0 slot
    psi = random_block(rng, (nk, ns, nb, ngk),
                       None if garbage else mask[:, None, None, :])
    gkc = np.asarray(jctx.gkvec.gkcart)
    vt, gk = mgga_from_numpy(vtau, np.repeat(gkc, ns, axis=0), "cpu")
    hk = ps.hk()
    hp, sp = apply_h_s_mgga(hk, vt, gk, psi_from_numpy(
        psi.reshape(nk * ns, nb, ngk), "cpu"))
    h0, s0 = apply_h_s(hk, psi_from_numpy(psi.reshape(nk * ns, nb, ngk),
                                          "cpu"))
    for ik in range(nk):
        for s in range(ns):
            prm = hk_complex(hkset_slice_r(jps, ik, s))
            jh, js = jax_mgga.apply_h_s_mgga(prm, jnp.asarray(vtau[s]),
                                             jnp.asarray(gkc[ik]),
                                             jnp.asarray(psi[ik, s]))
            b = ik * ns + s
            assert rel(hp[b].numpy(), np.asarray(jh)) <= 1e-12
            assert rel(sp[b].numpy(), np.asarray(js)) <= 1e-12
    # the tau term is there and S is untouched
    assert rel(hp.numpy(), h0.numpy()) > 1e-3
    torch.testing.assert_close(sp, s0, rtol=0, atol=0)


def test_constant_vtau_is_scaled_kinetic():
    # -1/2 div(c grad psi) = c (-1/2 laplacian psi): with v_tau = c the tau
    # term is c x the kinetic diagonal
    pctx = port_context(gk_cutoff=4.0, pw_cutoff=12.0, ngridk=(1, 1, 1),
                        num_bands=6, use_symmetry=False)
    dims = tuple(pctx.fft_coarse.dims)
    hk = make_hkset_params(pctx, np.full(dims, 0.05), device="cpu").hk()
    rng = np.random.default_rng(0)
    ngk = pctx.gkvec.ngk_max
    psi = psi_from_numpy(random_block(rng, (1, 4, ngk),
                                      np.asarray(pctx.gkvec.mask[0])), "cpu")
    c = 0.37
    vt, gk = mgga_from_numpy(np.full(dims, c), pctx.gkvec.gkcart, "cpu")
    h0, s0 = apply_h_s(hk, psi)
    h1, s1 = apply_h_s_mgga(hk, vt, gk, psi)
    ekin = torch.as_tensor(pctx.gkvec.kinetic()[0])
    torch.testing.assert_close(h1, h0 + c * ekin * psi, rtol=0, atol=1e-10)
    torch.testing.assert_close(s1, s0, rtol=0, atol=1e-14)


def test_tau_kset_matches_jax(deck):
    jctx, jps, ps, _, rng = deck
    nk, ns, ngk = jctx.gkvec.num_kpoints, jctx.num_spins, jctx.gkvec.ngk_max
    nb = 6
    mask = np.asarray(jctx.gkvec.mask)[:, None, None, :]
    psi = random_block(rng, (nk, ns, nb, ngk), mask)
    occ_w = rng.uniform(0.0, 0.3, (nk, ns, nb))
    gkc = np.asarray(jctx.gkvec.gkcart)
    want = np.asarray(jax_mgga.tau_kset(
        jps.fft_index, jnp.asarray(gkc), *map(jnp.asarray, split_cplx(psi)),
        jnp.asarray(occ_w), tuple(jctx.fft_coarse.dims)))
    _, gk = mgga_from_numpy(np.zeros(jctx.fft_coarse.dims), gkc, "cpu")
    got = tau_kset(ps, gk, psi_from_numpy(psi, "cpu"), torch.as_tensor(occ_w))
    assert got.shape == want.shape == (ns,) + tuple(jctx.fft_coarse.dims)
    assert rel(got.numpy(), want) <= 1e-12
    # and the fine-G tau both packages feed the potential
    pctx = port_context(**DECKS["nc" if ns == 1 else "us_spin"])
    tau_g = density_from_coarse_acc(pctx, got, grid_tables(pctx, "cpu"))
    assert rel(tau_g.numpy(), jax_from_acc(jctx, want)) <= 1e-12


def test_tau_integral_is_kinetic_energy():
    # Omega tau(G = 0) = sum occ <psi| -1/2 laplacian |psi> (Parseval)
    jctx, jps, ps, _, _ = make_deck("nc")
    pctx = port_context(**DECKS["nc"])
    rng = np.random.default_rng(1)
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = random_block(rng, (nk, 1, 4, ngk),
                       np.asarray(jctx.gkvec.mask)[:, None, None, :])
    occ_w = np.broadcast_to([2.0, 2.0, 1.0, 0.5], (nk, 1, 4)) / nk
    _, gk = mgga_from_numpy(np.zeros(jctx.fft_coarse.dims),
                            jctx.gkvec.gkcart, "cpu")
    acc = tau_kset(ps, gk, psi_from_numpy(psi, "cpu"),
                   torch.as_tensor(np.ascontiguousarray(occ_w)))
    tau_g = density_from_coarse_acc(pctx, acc, grid_tables(pctx, "cpu"))
    ekin = np.asarray(jctx.gkvec.kinetic())
    t_direct = float(np.sum(occ_w[:, 0, :, None] * ekin[:, None, :]
                            * np.abs(psi[:, 0]) ** 2))
    t_tau = float(tau_g[0, 0].real) * jctx.unit_cell.omega
    assert abs(t_tau - t_direct) <= 1e-10 * abs(t_direct)


def test_tau_symmetrization_under_spin_flip_ops():
    # the small ultrasoft cell with moments +0.5 / -0.5: a magnetic group of
    # 8 ops, 4 of them spin-flip (they swap the two atoms). tau with a
    # staggered spin part, tau_s = (rho0 +- m0) / 2 from the starting
    # density and magnetization, both invariant under the group (rho0 as a
    # scalar, m0 as an axial field). Each channel is symmetrized as a
    # scalar under every op, as the JAX package does (scf.py:1961-1964):
    # the sum survives, the spin part is averaged away, where the axial
    # treatment keeps it (ROADMAP queue 3)
    kw = dict(SMALL, ultrasoft=True, use_symmetry=True,
              moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]),
              extra_params={"num_mag_dims": 1, "xc_functionals": [
                  "XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]})
    jctx, pctx = jax_context(**kw), port_context(**kw)
    flips = [op.spin_sign < 0 for op in pctx.symmetry.ops]
    assert len(flips) == 8 and sum(flips) == 4
    rho0, m0 = initial_density_g(pctx), initial_magnetization_g(pctx)
    tau = np.stack([0.5 * (rho0 + m0), 0.5 * (rho0 - m0)])
    tb = build_sym_pw_tables(pctx, "cpu")
    got = symmetrize_tau(tb, torch.as_tensor(tau)).numpy()
    want = np.stack([jax_symmetrize_pw(jctx, t) for t in tau])
    assert rel(got, want) <= 1e-13
    axial = symmetrize_pw(tb, torch.as_tensor(m0), axial_z=True).numpy()
    assert rel(axial, m0) <= 1e-13
    assert rel(got[0] + got[1], rho0) <= 1e-13
    assert np.max(np.abs(got[0] - got[1])) <= 1e-13 * np.max(np.abs(m0))


def test_davidson_kset_mgga_matches_jax():
    # the tau operator inside the band solve, from the same start block
    jctx, jps, ps, vtau, rng = make_deck("nc", seed=5)
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    nb = 8
    mask = np.asarray(jctx.gkvec.mask)[:, None, None, :]
    x0 = random_block(rng, (nk, 1, nb, ngk), mask)
    gkc = np.asarray(jctx.gkvec.gkcart)
    ev_j, xr, xi, rn_j = jax_mgga.davidson_kset_mgga(
        jps, jnp.asarray(vtau), jnp.asarray(gkc), jnp.asarray(x0.real),
        jnp.asarray(x0.imag), num_steps=40, res_tol=1e-9)
    vt, gk = mgga_from_numpy(vtau, gkc, "cpu")
    ev, x, rn = davidson_kset_mgga(ps, vt, gk, psi_from_numpy(x0, "cpu"),
                                   num_steps=40, res_tol=1e-9)
    # from a random start the top bands of a few k-points are still
    # converging after 40 steps (in both packages alike, to ~1e-7): compare
    # the converged ones
    rn_j = np.asarray(rn_j)
    done = rn_j < 1e-8
    assert done[:, :, :6].all()
    assert np.max(np.abs(ev.numpy() - np.asarray(ev_j))[done]) <= 1e-10
    np.testing.assert_allclose(rn.numpy()[done], rn_j[done], rtol=0,
                               atol=1e-9)
    xj = np.asarray(xr) + 1j * np.asarray(xi)
    for ik in range(nk):
        # the lowest 2 bands are separated from the rest by > 0.1 Ha
        a = x.numpy()[ik, 0, :2]
        b = xj[ik, 0, :2]
        assert np.max(np.abs(a.conj().T @ a - b.conj().T @ b)) <= 1e-10


def test_gradient_scatter_keeps_g0_slot():
    # padded lanes (mask 0) point at box slot 0, the G = 0 slot: K11a
    # stores only valid lanes, so (G+k)_c psi(G = 0) survives there
    jctx, _, ps, _, rng = make_deck("nc")
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    dims = jctx.fft_coarse.dims
    n = int(np.prod(dims))
    hk = ps.hk()
    psi = psi_from_numpy(random_block(rng, (nk, 2, ngk)), "cpu")
    _, gk = mgga_from_numpy(np.zeros(dims), jctx.gkvec.gkcart, "cpu")
    valid = hk.mask > 0
    assert bool((~valid).any()) and bool((hk.fft_index[~valid] == 0).all())
    for c in range(3):
        box = k11.grad_to_box(psi, gk, c, hk.fft_index, hk.mask, n)
        for ik in range(nk):
            idx = hk.fft_index[ik][valid[ik]].long()
            want = gk[ik, :, c][valid[ik]] * psi[ik][:, valid[ik]]
            torch.testing.assert_close(box[ik][:, idx], want, rtol=0, atol=0)
            off = torch.ones(n, dtype=torch.bool)
            off[idx] = False
            assert bool((box[ik][:, off] == 0).all())


def test_gradient_gather_sums_in_the_jax_order():
    # K11b adds each component into h as it comes, h + (0.5 g_c b_c) mask
    # for c = 0, 1, 2 (exact); the JAX package sums the components first,
    # h + (0.5 (g0 b0 + g1 b1 + g2 b2)) mask, an ulp of h away
    jctx, _, ps, _, rng = make_deck("nc")
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    n = int(np.prod(jctx.fft_coarse.dims))
    hk = ps.hk()
    _, gk = mgga_from_numpy(np.zeros(jctx.fft_coarse.dims),
                            jctx.gkvec.gkcart, "cpu")
    boxes = [psi_from_numpy(random_block(rng, (nk, 3, n)), "cpu")
             for _ in range(3)]
    h0 = psi_from_numpy(random_block(rng, (nk, 3, ngk)), "cpu")
    h = h0.clone()
    for c in range(3):
        k11.box_to_pw_tau(boxes[c], gk, c, hk.fft_index, hk.mask, h)
    idx = hk.fft_index.long()[:, None, :].expand(nk, 3, ngk)
    back = [torch.gather(b, 2, idx) for b in boxes]
    m = hk.mask[:, None, :]
    want = h0.clone()
    for c in range(3):
        want = want + (0.5 * (gk[:, None, :, c] * back[c])) * m
    torch.testing.assert_close(h, want, rtol=0, atol=0)
    acc = torch.zeros_like(h)
    for c in range(3):
        acc = acc + gk[:, None, :, c] * back[c]
    jax_order = h0 + 0.5 * acc * m
    assert float((h - jax_order).abs().max()) <= 1e-15 * float(
        jax_order.abs().max())


def test_wrappers_check_their_inputs():
    jctx, _, ps, _, _ = make_deck("nc")
    hk = ps.hk()
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = torch.zeros((nk, 2, ngk), dtype=torch.complex128)
    _, gk = mgga_from_numpy(np.zeros(jctx.fft_coarse.dims),
                            jctx.gkvec.gkcart, "cpu")
    with pytest.raises(ValueError, match="comp"):
        k11.grad_to_box(psi, gk, 3, hk.fft_index, hk.mask, 8)
    with pytest.raises(ValueError, match="gkc"):
        k11.grad_to_box(psi, gk[0], 0, hk.fft_index, hk.mask, 8)
    with pytest.raises(ValueError, match="mask"):
        k11.grad_to_box(psi, gk, 0, hk.fft_index, None, 8)
    box = torch.zeros((nk, 2, 8), dtype=torch.complex128)
    with pytest.raises(ValueError, match="hpsi"):
        k11.box_to_pw_tau(box, gk, 0, hk.fft_index, hk.mask,
                          torch.zeros((nk, 1, ngk), dtype=torch.complex128))


def test_mgga_from_numpy_shapes():
    vt, gk = mgga_from_numpy(np.ones((4, 5, 6)), np.zeros((2, 7, 3)), "cpu")
    assert vt.shape == (1, 4, 5, 6) and vt.dtype == torch.float64
    assert gk.shape == (2, 7, 3) and gk.dtype == torch.float64
    vt, _ = mgga_from_numpy(np.ones((2, 4, 5, 6)), np.zeros((7, 3)), "cpu")
    assert vt.shape == (2, 4, 5, 6)
