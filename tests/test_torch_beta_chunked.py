"""Port parity of the chunked-projector path (ops/beta_chunked.py with K9)
against the JAX package: the host tables, the K9 plain version against the
JAX chunk expression, chunked_nonlocal and apply_h_s_chunked, on small
2-atom decks (norm-conserving at Gamma and at a k-point off Gamma,
ultrasoft at Gamma), with one atom per chunk (two chunk steps) and with 16
(one step, 14 padded atoms). On the CPU the wrapper takes K9's plain
version. Inputs are made with numpy from a seed and handed to both
packages. Bounds: host tables equal; operators 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.scf import _h_o_diag as jax_h_o_diag
from sirius_tpu.ops import beta_chunked as jb
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import CHUNKED_KEYS, chunked_params_from_numpy
from sirius_tpu_torch.kernels.beta_chunk import beta_chunk
from sirius_tpu_torch.ops import beta_chunked as tb
from sirius_tpu_torch.parallel.batched import compute_h_diag, compute_o_diag
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SHAPE = dict(gk_cutoff=3.0, pw_cutoff=7.0, num_bands=8)
# deck name -> (k-mesh, species, the k-point taken)
DECKS = {
    "nc_gamma": ((1, 1, 1), dict(ultrasoft=False, use_symmetry=False), 0),
    "nc_k3": ((2, 2, 2), dict(ultrasoft=False, use_symmetry=False), 3),
    "us_gamma": ((1, 1, 1), dict(ultrasoft=True, use_symmetry=False), 0),
}
TABLE_FIELDS = ("nxi_max", "chunk", "pos", "xi_rf", "xi_lm", "xi_cph", "dmat",
                "qmat", "rlm", "q", "mk", "ri_grid", "dq", "pref")


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=sorted(DECKS))
def deck(request):
    ngridk, kind, ik = DECKS[request.param]
    spec = dict(SHAPE, ngridk=ngridk, **kind)
    jctx = jax_context(**spec)
    rng = np.random.default_rng(70)
    d = np.array(jctx.beta.dion, dtype=np.float64)
    for _, off, nbf in jctx.beta.atom_blocks(jctx.unit_cell):
        a = 0.05 * rng.standard_normal((nbf, nbf))
        d[off:off + nbf, off:off + nbf] += a + a.T
    veff = rng.uniform(-1.0, 0.5, tuple(jctx.fft_coarse.dims))
    return dict(name=request.param, jctx=jctx, pctx=port_context(**spec),
                ik=ik, d=d, veff=veff, rng=rng)


def jax_prm(deck, chunk):
    """The JAX make_chunked_hk dict with this deck's potential and D."""
    jctx = deck["jctx"]
    prm = jb.make_chunked_hk(jctx, deck["ik"], chunk=chunk)
    return dict(prm, veff_r=jnp.asarray(deck["veff"]),
                dmat=jnp.asarray(jb.pack_dmat_chunks(jctx, deck["d"], chunk)))


def port_prm(deck, chunk):
    return chunked_params_from_numpy(
        {k: np.asarray(v) for k, v in jax_prm(deck, chunk).items()}, "cpu")


@pytest.mark.parametrize("chunk", [1, 16])
def test_build_tables_match_jax(deck, chunk):
    want = jb.build_tables(deck["jctx"], deck["ik"], deck["d"], chunk=chunk)
    got = tb.build_tables(deck["pctx"], deck["ik"], deck["d"], chunk=chunk)
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    np.testing.assert_array_equal(
        tb.pack_dmat_chunks(deck["pctx"], deck["d"], chunk),
        jb.pack_dmat_chunks(deck["jctx"], deck["d"], chunk))
    assert got.pos.shape[:2] == ((2 + chunk - 1) // chunk, chunk)


def test_make_chunked_hk_matches_jax(deck):
    want = jb.make_chunked_hk(deck["jctx"], deck["ik"], chunk=16)
    got = tb.make_chunked_hk(deck["pctx"], deck["ik"], chunk=16, device="cpu")
    for key in CHUNKED_KEYS:
        w = np.asarray(want[key])
        if key in ("cph_re", "cph_im"):
            g = (got.cph.real if key == "cph_re" else got.cph.imag).numpy()
        elif key == "qmat_c":
            g = np.zeros_like(w) if got.qmat_c is None else got.qmat_c.numpy()
        elif key in ("dq", "pref"):
            g = getattr(got, key)
        else:
            g = getattr(got, key).numpy().reshape(w.shape)
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert (got.qmat_c is None) == deck["name"].startswith("nc")


def jax_chunk_beta(prm, s):
    """The JAX package's projector block of chunk step s: the expressions
    of apply_h_s_chunked (beta_chunked.py:279-301), evaluated here."""
    rdt = prm["q"].dtype
    iq = jnp.clip(prm["q"] / prm["dq"], 0.0, prm["ri_grid"].shape[1] - 1.001)
    i0 = iq.astype(jnp.int32)
    t = (iq - i0).astype(rdt)
    ri_all = (prm["ri_grid"][:, i0] * (1.0 - t)
              + prm["ri_grid"][:, i0 + 1] * t) * prm["mask"]
    cph = (prm["cph_re"] + 1j * prm["cph_im"])[s]
    ri = ri_all[prm["xi_rf"][s]]
    ang = prm["rlm"][:, prm["xi_lm"][s]]
    phase = jnp.exp((-2j * jnp.pi) * (prm["mk"] @ prm["pos"][s].T))
    return np.asarray(prm["pref"] * cph[:, :, None]
                      * jnp.transpose(ang, (1, 2, 0)).astype(jnp.complex128)
                      * ri.astype(jnp.complex128)
                      * jnp.transpose(phase)[:, None, :])


@pytest.mark.parametrize("chunk", [1, 16])
def test_beta_chunk_plain_matches_jax_expression(deck, chunk):
    jp = jax_prm(deck, chunk)
    prm = port_prm(deck, chunk)
    natoms = deck["jctx"].unit_cell.num_atoms
    for s in range(prm.num_steps):
        got = prm.beta(s).numpy()
        want = jax_chunk_beta(jp, s)
        assert rel(got, want) <= 1e-12
        # padded atoms (cph 0) give exact zeros
        live = min(chunk, natoms - s * chunk)
        assert not np.any(got[live:])
    assert beta_chunk.launches == 0


def test_beta_chunk_against_dense_table(deck):
    # the generated projectors are the dense table's up to the linear
    # interpolation of the radial integrals (NQ >= 8192 points)
    prm = port_prm(deck, 1)
    jctx = deck["jctx"]
    dense = np.asarray(jctx.beta.beta_gk[deck["ik"]])
    for ia, off, nbf in jctx.beta.atom_blocks(jctx.unit_cell):
        got = prm.beta(ia).numpy()[0, :nbf]
        assert rel(got, dense[off:off + nbf]) <= 1e-6


@pytest.mark.parametrize("chunk", [1, 16])
def test_chunked_nonlocal_matches_jax(deck, chunk):
    jctx = deck["jctx"]
    ngk = jctx.gkvec.ngk_max
    psi = (deck["rng"].standard_normal((5, ngk))
           + 1j * deck["rng"].standard_normal((5, ngk)))
    tabs = jb.build_tables(jctx, deck["ik"], deck["d"], chunk=chunk)
    mask = jnp.asarray(jctx.gkvec.mask[deck["ik"]])
    jh, js = jb.chunked_nonlocal(tabs, jnp.asarray(psi), mask=mask)
    h, s = tb.chunked_nonlocal(port_prm(deck, chunk), torch.as_tensor(psi)[None])
    assert rel(h[0].numpy(), np.asarray(jh)) <= 1e-12
    if deck["name"].startswith("us"):
        assert rel(s[0].numpy(), np.asarray(js)) <= 1e-12
    else:
        assert not np.any(np.asarray(js)) and not torch.any(s != 0)


@pytest.mark.parametrize("chunk", [1, 16])
def test_apply_h_s_chunked_matches_jax(deck, chunk):
    jctx = deck["jctx"]
    ngk = jctx.gkvec.ngk_max
    rng = deck["rng"]
    psi = rng.standard_normal((6, ngk)) + 1j * rng.standard_normal((6, ngk))
    jh, js = jb.apply_h_s_chunked(jax_prm(deck, chunk), jnp.asarray(psi))
    calls = tb.apply_h_s_chunked.calls
    h, s = tb.apply_h_s_chunked(port_prm(deck, chunk), torch.as_tensor(psi)[None])
    assert tb.apply_h_s_chunked.calls == calls + 1
    assert rel(h[0].numpy(), np.asarray(jh)) <= 1e-12
    assert rel(s[0].numpy(), np.asarray(js)) <= 1e-12


def test_chunked_diagonals_match_jax(deck):
    # the chunked path's preconditioner diagonals, as run_scf builds them:
    # compute_h_diag / compute_o_diag on the dense table, the JAX package's
    # _h_o_diag to 1e-12 (not the generated chunks, which differ from it
    # by the radial interpolation's 1e-6)
    jctx, pctx, ik = deck["jctx"], deck["pctx"], deck["ik"]
    prm = tb.make_chunked_hk(pctx, ik, chunk=1, device="cpu")
    beta = torch.as_tensor(pctx.beta.beta_gk[ik:ik + 1]
                           * pctx.gkvec.mask[ik][None, None])
    v0 = 0.3
    d = torch.as_tensor(deck["d"], dtype=torch.complex128)[None]
    h = compute_h_diag(prm.ekin, prm.mask, beta, d, v0)[0, 0].numpy()
    o = compute_o_diag(pctx)[ik]
    want_h, want_o = jax_h_o_diag(jctx, ik, v0, deck["d"])
    assert rel(h, np.asarray(want_h)) <= 1e-12
    assert rel(o, np.asarray(want_o)) <= 1e-12
