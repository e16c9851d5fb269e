"""Port parity of the Gamma packed-real path (ops/gamma.py with K8a, K8b,
K1c in real mode and K2 on float64 blocks) against the JAX package on small
Gamma-only decks, norm-conserving and ultrasoft. On the CPU the wrappers
take the kernels' plain versions. Inputs are made with numpy from a seed
and handed to both packages. Bounds: host tables equal; operators 1e-12
relative; eigenvalues from one start block 1e-10 Ha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.scf import _h_o_diag as jax_h_o_diag
from sirius_tpu.ops import gamma as jg
from sirius_tpu.solvers.davidson import subspace_rotate as subspace_rotate_jax
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import (GAMMA_KEYS, gamma_params_from_numpy,
                                      gamma_spin_params_from_numpy,
                                      packed_from_numpy)
from sirius_tpu_torch.kernels import gamma_pack
from sirius_tpu_torch.kernels.davidson_residual import davidson_residual
from sirius_tpu_torch.kernels.veff_multiply import veff_multiply_real
from sirius_tpu_torch.ops import gamma as tg
from sirius_tpu_torch.solvers.davidson import subspace_rotate
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

GAMMA = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8)
KINDS = {"nc": dict(ultrasoft=False, use_symmetry=False),
         "us": dict(ultrasoft=True, use_symmetry=False)}
MAP_FIELDS = ("zero", "rep", "par", "slot_re", "slot_im", "im_sign", "scale")


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def screened_d(ctx, rng):
    """The bare D plus a symmetric change inside each atom's block: the
    block-diagonal structure a screened D has."""
    d = np.array(ctx.beta.dion, dtype=np.float64)
    for _, off, nbf in ctx.beta.atom_blocks(ctx.unit_cell):
        a = 0.05 * rng.standard_normal((nbf, nbf))
        d[off:off + nbf, off:off + nbf] += a + a.T
    return d


@pytest.fixture(scope="module", params=sorted(KINDS))
def deck(request):
    spec = dict(GAMMA, **KINDS[request.param])
    jctx = jax_context(**spec)
    pctx = port_context(**spec)
    gm = jg.build_gamma_map(np.asarray(jctx.gkvec.millers[0]),
                            np.asarray(jctx.gkvec.mask[0]))
    rng = np.random.default_rng(21)
    veff = rng.uniform(-1.0, 0.5, tuple(jctx.fft_coarse.dims))
    d = screened_d(jctx, rng)
    jgp = jg.make_gamma_params(jctx, veff, gm, dmat=d)
    arrays = {k: np.asarray(getattr(jgp, k)) for k in GAMMA_KEYS}
    return dict(kind=request.param, jctx=jctx, pctx=pctx, gm=gm, veff=veff,
                d=d, jgp=jgp, arrays=arrays, rng=rng)


def test_build_gamma_map_matches_jax(deck):
    pctx = deck["pctx"]
    gm = tg.build_gamma_map(np.asarray(pctx.gkvec.millers[0]),
                            np.asarray(pctx.gkvec.mask[0]))
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(gm, name),
                                      getattr(deck["gm"], name), err_msg=name)
    assert 1 + 2 * len(gm.rep) == int(pctx.gkvec.num_gk[0])


def test_make_gamma_params_matches_jax(deck):
    gm = deck["gm"]
    gp = tg.make_gamma_params(deck["pctx"], deck["veff"], gm, dmat=deck["d"],
                              device="cpu")
    a = deck["arrays"]
    for name in GAMMA_KEYS:
        got = getattr(gp, name)
        if name == "qmat" and got is None:
            assert not np.any(a["qmat"])
            continue
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, a[name], err_msg=name)
    # K8b's pair tables: the box positions of each pair's two members
    fidx = np.asarray(deck["jctx"].gkvec.fft_index[0])
    np.testing.assert_array_equal(gp.rep_box.numpy(), fidx[gm.rep])
    np.testing.assert_array_equal(gp.par_box.numpy(), fidx[gm.par])
    assert gp.zero_box == fidx[gm.zero]
    assert (gp.qmat is None) == (deck["kind"] == "nc")


def test_pack_unpack_and_diagonals_match_jax(deck):
    gm, rng = deck["gm"], deck["rng"]
    ngk = len(gm.slot_re)
    c = rng.standard_normal((3, ngk)) + 1j * rng.standard_normal((3, ngk))
    np.testing.assert_array_equal(tg.pack(gm, c), jg.pack(gm, c))
    x = rng.standard_normal((3, ngk))
    np.testing.assert_array_equal(tg.unpack(gm, x), jg.unpack(gm, x))
    gp = gamma_params_from_numpy(deck["arrays"], "cpu")
    assert rel(tg.unpack_device(gp, torch.as_tensor(x)).numpy(),
               jg.unpack(gm, x)) <= 1e-15
    h, o = rng.uniform(1, 3, ngk), rng.uniform(1, 2, ngk)
    for got, want in zip(tg.pack_diags(gm, h, o), jg.pack_diags(gm, h, o)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tg.pack_diags(gm, torch.as_tensor(h)[None],
                                       torch.as_tensor(o)[None]),
                         jg.pack_diags(gm, h, o)):
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_apply_h_s_gamma_matches_jax(deck):
    gp = gamma_params_from_numpy(deck["arrays"], "cpu")
    ngk = gp.mask_p.shape[0]
    x = deck["rng"].standard_normal((6, ngk))
    jh, js = jg.apply_h_s_gamma(deck["jgp"], jnp.asarray(x))
    calls = tg.apply_h_s_gamma.calls
    hx, sx = tg.apply_h_s_gamma(gp, packed_from_numpy(x[None], "cpu"))
    assert tg.apply_h_s_gamma.calls == calls + 1
    assert rel(hx[0].numpy(), np.asarray(jh)) <= 1e-12
    assert rel(sx[0].numpy(), np.asarray(js)) <= 1e-12
    assert gamma_pack.unpack_to_box.launches == 0
    assert gamma_pack.box_to_packed_hx.launches == 0
    assert veff_multiply_real.launches == 0


def test_davidson_gamma_matches_jax(deck):
    # one start block, the same num_steps: the same eigenvalues (the
    # subspace eigenproblems are real-symmetric on both sides)
    jctx, gm = deck["jctx"], deck["gm"]
    gp = gamma_params_from_numpy(deck["arrays"], "cpu")
    h, o = jax_h_o_diag(jctx, 0, 0.3, deck["d"])
    hp, op = jg.pack_diags(gm, np.asarray(h), np.asarray(o))
    nb = jctx.num_bands
    x0 = deck["rng"].standard_normal((nb, len(hp))) * deck["arrays"]["mask_p"]
    ev_j, _, rn_j = jg.davidson_gamma(deck["jgp"], jnp.asarray(x0),
                                      jnp.asarray(hp), jnp.asarray(op),
                                      num_steps=30, res_tol=1e-6)
    ev, x, rn = tg.davidson_gamma(gp, packed_from_numpy(x0[None], "cpu"),
                                  torch.as_tensor(hp)[None],
                                  torch.as_tensor(op)[None], num_steps=30,
                                  res_tol=1e-6)
    assert x.dtype == torch.float64
    assert np.max(np.abs(ev[0].numpy() - np.asarray(ev_j))) <= 1e-10
    # the residuals of an unconverged fixed-step solve agree in size only:
    # within degenerate multiplets the per-band convergence lock depends on
    # the rotation eigh picks
    assert np.max(rn[0].numpy()) <= 10.0 * np.max(np.asarray(rn_j))
    assert davidson_residual.launches_f64 == 0


def test_per_spin_gamma_solve_matches_jax(deck):
    # the polarized Gamma solve: one GammaParams, veff_r and D swapped per
    # spin, each spin's packed LCAO-like block rotated under its own
    # operator and solved with its own diagonals (scf.py:1376-1440)
    jctx, gm, rng = deck["jctx"], deck["gm"], deck["rng"]
    veff = np.stack([deck["veff"] + 0.05, deck["veff"] - 0.05])
    dion = np.stack([deck["d"], screened_d(jctx, rng)])
    gps = gamma_spin_params_from_numpy(deck["arrays"], veff, dion, "cpu")
    nb = jctx.num_bands
    ngk = deck["arrays"]["mask_p"].shape[0]
    big = rng.standard_normal((nb + 4, ngk)) * deck["arrays"]["mask_p"]
    evs = []
    for ispn, gp in enumerate(gps):
        jgp = deck["jgp"]._replace(veff_r=jnp.asarray(veff[ispn]),
                                   dion=jnp.asarray(dion[ispn]))
        hx, sx = jg.apply_h_s_gamma(jgp, jnp.asarray(big))
        x0_j = subspace_rotate_jax(jnp.asarray(big), hx, sx, nb,
                                   mask=jgp.mask_p)
        xb = packed_from_numpy(big[None], "cpu")
        hxt, sxt = tg.apply_h_s_gamma(gp, xb)
        x0 = subspace_rotate(xb, hxt, sxt, nb, mask=gp.mask_p[None])
        h, o = jax_h_o_diag(jctx, 0, 0.3, dion[ispn])
        hp, op = jg.pack_diags(gm, np.asarray(h), np.asarray(o))
        ev_j, _, _ = jg.davidson_gamma(jgp, x0_j, jnp.asarray(hp),
                                       jnp.asarray(op), num_steps=30,
                                       res_tol=1e-6)
        ev, _, _ = tg.davidson_gamma(gp, x0, torch.as_tensor(hp)[None],
                                     torch.as_tensor(op)[None], num_steps=30,
                                     res_tol=1e-6)
        assert np.max(np.abs(ev[0].numpy() - np.asarray(ev_j))) <= 1e-10
        evs.append(ev[0].numpy())
    assert np.max(np.abs(evs[0] - evs[1])) > 1e-3


def test_density_gamma_matches_jax(deck):
    gp = gamma_params_from_numpy(deck["arrays"], "cpu")
    rng = deck["rng"]
    x = rng.standard_normal((5, gp.mask_p.shape[0]))
    occ = rng.uniform(0.0, 2.0, 5)
    want = np.asarray(jg.density_gamma(deck["jgp"], jnp.asarray(x),
                                       jnp.asarray(occ)))
    got = tg.density_gamma(gp, torch.as_tensor(x), torch.as_tensor(occ))
    assert rel(got.numpy(), want) <= 1e-12


def padded_map():
    """A 5-lane Gamma sphere (G = 0 and two pairs) plus two padded lanes,
    which point at box slot 0, the slot of G = 0."""
    millers = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                        [0, -1, 0], [0, 0, 0], [0, 0, 0]])
    mask = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    fft_index = np.array([0, 1, 3, 8, 6, 0, 0], dtype=np.int32)
    return millers, mask, fft_index


def test_unpack_to_box_keeps_g0_slot():
    millers, mask, fidx = padded_map()
    gm = tg.build_gamma_map(millers, mask)
    jm = jg.build_gamma_map(millers, mask)
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(gm, name), getattr(jm, name))
    assert list(gm.slot_re[5:]) == [5, 6] and not np.any(gm.scale[5:])
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 3, 7))  # padded packed slots hold garbage
    mask_p = np.array([1.0] * 5 + [0.0] * 2)
    n = 9
    # the JAX package's expression (gamma.py:216-226): an additive scatter
    xm = x * mask_p
    c = (gm.scale * np.take(xm, gm.slot_re, axis=-1)
         + 1j * (gm.scale * gm.im_sign) * np.take(xm, gm.slot_im, axis=-1))
    want = np.asarray(jnp.zeros((2, 3, n), dtype=jnp.complex128)
                      .at[..., fidx].add(jnp.asarray(c)))
    t = torch.as_tensor
    box = gamma_pack.unpack_to_box(
        t(x), t(mask_p), t(gm.slot_re), t(gm.slot_im), t(gm.im_sign),
        t(gm.scale), t(fidx), n)
    np.testing.assert_array_equal(box.numpy(), want)
    # slot 0 holds c(0) = x[0], not a padded lane's value
    np.testing.assert_array_equal(box[..., 0].numpy(), x[..., 0] + 0j)
    with pytest.raises(ValueError):
        gamma_pack.unpack_to_box(t(x).float(), t(mask_p), t(gm.slot_re),
                                 t(gm.slot_im), t(gm.im_sign), t(gm.scale),
                                 t(fidx), n)
    with pytest.raises(ValueError):
        gamma_pack.unpack_to_box(t(x), t(mask_p), t(gm.slot_re).long(),
                                 t(gm.slot_im), t(gm.im_sign), t(gm.scale),
                                 t(fidx), n)


def test_box_to_packed_hx_matches_jax_pack():
    millers, mask, fidx = padded_map()
    gm = tg.build_gamma_map(millers, mask)
    rng = np.random.default_rng(31)
    n = 9
    vbox = rng.standard_normal((2, 3, n)) + 1j * rng.standard_normal((2, 3, n))
    x = rng.standard_normal((2, 3, 7))
    mask_p = np.array([1.0] * 5 + [0.0] * 2)
    ekin_p = rng.uniform(0.0, 4.0, 7)
    # the JAX package's expressions (gamma.py:233-245 and _pack_device)
    vg = jnp.asarray(vbox)[..., fidx]
    vpack = jg._pack_device(vg, jnp.asarray(gm.slot_re), jnp.asarray(gm.slot_im),
                            jnp.asarray(gm.im_sign), jnp.asarray(gm.scale),
                            jnp.asarray(gm.zero), 7)
    xm = x * mask_p
    ek = np.where(mask_p > 0, ekin_p, 0.0)
    want_h = (ek * xm + np.asarray(vpack)) * mask_p
    t = torch.as_tensor
    hx, sx = gamma_pack.box_to_packed_hx(
        t(vbox), t(x), t(ekin_p), t(mask_p), t(fidx[gm.rep]), t(fidx[gm.par]),
        int(fidx[gm.zero]))
    np.testing.assert_array_equal(hx.numpy(), want_h)
    np.testing.assert_array_equal(sx.numpy(), xm * mask_p)
    with pytest.raises(ValueError, match="pairs"):
        gamma_pack.box_to_packed_hx(t(vbox), t(x[..., :4]), t(ekin_p[:4]),
                                    t(mask_p[:4]), t(fidx[gm.rep]),
                                    t(fidx[gm.par]), 0)


@pytest.mark.parametrize("ns", [1, 2])
def test_veff_multiply_real_plain_matches_jax_product(ns):
    # K1c real mode is gamma.py:230-233: the real part times veff, as a
    # complex box with a zero imaginary part
    rng = np.random.default_rng(50 + ns)
    b, r, n = 2 * ns, 3, 40
    fr = rng.standard_normal((b, r, n)) + 1j * rng.standard_normal((b, r, n))
    veff = rng.standard_normal((ns, n))
    want = np.real(fr) * np.tile(veff, (b // ns, 1))[:, None, :] + 0j
    got = veff_multiply_real(torch.as_tensor(fr), torch.as_tensor(veff))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.any(got.numpy().imag)
    assert veff_multiply_real.launches == 0


def test_davidson_residual_float64_matches_complex_path():
    # K2 on packed-real blocks: the same numbers as on the same blocks held
    # as complex128 (the isometry makes every sum a real one), to rounding:
    # the complex row norm squares |r| after a square root
    rng = np.random.default_rng(8)
    b, nb, ngk = 2, 3, 20
    x, hx, sx = (rng.standard_normal((b, nb, ngk)) for _ in range(3))
    hx[1, 2] = 0.7 * sx[1, 2]
    x[1, 2] = sx[1, 2]
    mask = np.ones((b, ngk))
    mask[:, -4:] = 0.0
    hd = rng.uniform(1, 3, (b, ngk))
    od = np.ones((b, ngk))
    t = torch.as_tensor
    got = davidson_residual(t(x), t(hx), t(sx), t(hd), t(od), t(mask), 1e-8)
    ref = davidson_residual(t(x + 0j), t(hx + 0j), t(sx + 0j), t(hd), t(od),
                            t(mask), 1e-8)
    assert got[2].dtype == torch.float64
    for a, c in zip(got, ref):
        torch.testing.assert_close(a, c.real if c.is_complex() else c,
                                   rtol=1e-14, atol=0)
    assert float(got[1][1, 2]) < 1e-12
    ev, rn, w = davidson_residual(t(x), t(hx), t(sx), None, None, None, 1e-8,
                                  want_w=False)
    assert w is None
    torch.testing.assert_close(ev, got[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        davidson_residual(t(x).float(), t(hx).float(), t(sx).float(), t(hd),
                          t(od), t(mask), 1e-8)
    assert davidson_residual.launches_f64 == 0
