"""Port parity: the batched Davidson band solve (K2 residual and
preconditioner) and the LCAO subspace initialization against the JAX
package, from the same start block with the same num_steps, on the small
deck, unpolarized and with two spin channels (the exchange-split
potential of a collinear run, batch entry ik * 2 + ispn; also the density
matrix of the two channels). num_steps is 40, where residuals are ~1e-10 and the occupied
projector is therefore defined to 1e-10. Compared: eigenvalues and the projector onto the occupied subspace
(the vectors' phases differ between LAPACK builds). Bound: 1e-10 Ha."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import initial_density_g
from sirius_tpu.dft.potential import generate_potential
from sirius_tpu.dft.scf import _initial_subspace as jax_initial_subspace
from sirius_tpu.dft.xc import XCFunctional
from sirius_tpu.ops.hamiltonian import apply_h_s as jax_apply_h_s
from sirius_tpu.dft.density import initial_magnetization_g
from sirius_tpu.parallel.batched import davidson_kset as jax_davidson_kset
from sirius_tpu.parallel.batched import density_matrix_kset as jax_dm_kset
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import initialize_subspace_kset as jax_init
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.parallel.batched import split_cplx
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import HKSET_KEYS, hkset_from_numpy, psi_from_numpy
from sirius_tpu_torch.dft.scf import _initial_subspace as port_initial_subspace
from sirius_tpu_torch.kernels.davidson_residual import davidson_residual
from sirius_tpu_torch.ops.hamiltonian import apply_h_s
from sirius_tpu_torch.parallel.batched import (davidson_kset,
                                               density_matrix_kset,
                                               initialize_subspace_kset)
from sirius_tpu_torch.solvers.davidson import num_applies, residual_health
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
             ultrasoft=False, use_symmetry=False)
NOCC = 4  # 8 electrons, doubly occupied


def projector(x, nocc):
    """[nk, ns, ngk, ngk] projector onto the span of the lowest nocc rows."""
    v = x[:, :, :nocc, :]
    return np.einsum("ksbg,ksbh->ksgh", v.conj(), v)


def occupied_projectors(x, evals, gap=1e-3):
    """Per (k, spin), the projector onto the lowest n >= NOCC bands where n
    ends at a gap: the occupied subspace, widened past a degenerate
    multiplet that straddles band NOCC so the projector is defined."""
    out = []
    for ik in range(x.shape[0]):
        for s in range(x.shape[1]):
            ev = evals[ik, s]
            n = next(n for n in range(NOCC, len(ev))
                     if ev[n] - ev[n - 1] > gap)
            v = x[ik, s, :n]
            out.append(v.conj().T @ v)
    return out


@pytest.fixture(scope="module")
def setup():
    # the operator of the first SCF iteration: the potential of the
    # superposed free-atom density
    jctx = jax_context(**SMALL)
    pot = generate_potential(jctx, initial_density_g(jctx),
                             XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]))
    jps = jax_hkset(jctx, pot.veff_r_coarse, v0=float(pot.veff_g[0].real))
    arrays = {k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS}
    big = jax_initial_subspace(jctx)
    return jctx, jps, hkset_from_numpy(arrays, "cpu"), big


def test_initial_subspace_block_identical(setup):
    jctx, _, _, big = setup
    np.testing.assert_array_equal(port_initial_subspace(port_context(**SMALL)), big)


def test_initialize_subspace_matches_jax(setup):
    _, jps, ps, big = setup
    nb = 8
    jr, ji = jax_init(jps, *map(jnp.asarray, split_cplx(big)), nb)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = initialize_subspace_kset(ps, psi_from_numpy(big, "cpu"), nb)
    assert got.shape == want.shape
    # the LCAO block holds nb = 8 orbitals, so the Ritz rotation keeps the
    # whole span; the lowest 4 Ritz values are degenerate at some k-points,
    # so the span of all nb rows and the Ritz values are what is defined
    assert np.max(np.abs(projector(got.numpy(), nb) - projector(want, nb))) <= 1e-10
    hx, _ = apply_h_s(ps.hk(), got.reshape(-1, nb, got.shape[-1]))
    ritz = torch.sum(got.reshape(hx.shape).conj() * hx, -1).real.numpy()
    jhk = [hk_complex(hkset_slice_r(jps, ik, 0)) for ik in range(want.shape[0])]
    ritz_j = np.stack([np.real(np.sum(want[ik, 0].conj() * np.asarray(
        jax_apply_h_s(jhk[ik], jnp.asarray(want[ik, 0]))[0]), -1))
        for ik in range(want.shape[0])])
    assert np.max(np.abs(np.sort(ritz, -1) - np.sort(ritz_j, -1))) <= 1e-10


def test_davidson_kset_matches_jax(setup):
    _, jps, ps, big = setup
    nb = 8
    jr, ji = jax_init(jps, *map(jnp.asarray, split_cplx(big)), nb)
    x0 = np.asarray(jr) + 1j * np.asarray(ji)
    ev_j, xr, xi, rn_j = jax_davidson_kset(jps, jnp.asarray(x0.real),
                                           jnp.asarray(x0.imag), num_steps=40,
                                           res_tol=1e-9)
    ev, x, rn = davidson_kset(ps, psi_from_numpy(x0, "cpu"), num_steps=40,
                              res_tol=1e-9)
    assert np.max(np.abs(ev.numpy() - np.asarray(ev_j))) <= 1e-10
    xj = np.asarray(xr) + 1j * np.asarray(xi)
    for a, b in zip(occupied_projectors(x.numpy(), np.asarray(ev_j)),
                    occupied_projectors(xj, np.asarray(ev_j))):
        assert np.max(np.abs(a - b)) <= 1e-10
    np.testing.assert_allclose(rn.numpy(), np.asarray(rn_j), rtol=0, atol=1e-9)
    assert residual_health(rn)[1]


@pytest.fixture(scope="module")
def polarized():
    # ultrasoft species without symmetry, moments +0.5 / -0.5: two spin
    # channels under V +- B_z of the first iteration's potential
    spec = dict(SMALL, ultrasoft=True,
                moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]),
                extra_params={"num_mag_dims": 1})
    jctx = jax_context(**spec)
    pot = generate_potential(jctx, initial_density_g(jctx),
                             XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             initial_magnetization_g(jctx))
    assert pot.veff_r_coarse.shape[0] == 2
    rng = np.random.default_rng(14)
    d = np.array([jctx.beta.dion + 0.01 * s * rng.standard_normal(
        jctx.beta.dion.shape) for s in (1.0, -1.0)])
    d = 0.5 * (d + d.transpose(0, 2, 1))
    jps = jax_hkset(jctx, pot.veff_r_coarse, d,
                    v0=float(pot.veff_g[0].real))
    arrays = {k: np.asarray(getattr(jps, k)) for k in HKSET_KEYS}
    return jctx, jps, hkset_from_numpy(arrays, "cpu"), jax_initial_subspace(jctx)


def test_polarized_kset_matches_jax(polarized):
    jctx, jps, ps, big = polarized
    nb = 8
    nk = jctx.gkvec.num_kpoints
    assert big.shape[:2] == (nk, 2) and ps.num_spins == 2
    assert ps.hk().ekin.shape[0] == 2 * nk
    jr, ji = jax_init(jps, *map(jnp.asarray, split_cplx(big)), nb)
    x0 = np.asarray(jr) + 1j * np.asarray(ji)
    got0 = initialize_subspace_kset(ps, psi_from_numpy(big, "cpu"), nb)
    assert np.max(np.abs(projector(got0.numpy(), nb) - projector(x0, nb))) \
        <= 1e-10
    ev_j, xr, xi, _ = jax_davidson_kset(jps, jnp.asarray(x0.real),
                                        jnp.asarray(x0.imag), num_steps=40,
                                        res_tol=1e-9)
    ev, x, rn = davidson_kset(ps, psi_from_numpy(x0, "cpu"), num_steps=40,
                              res_tol=1e-9)
    ev_j = np.asarray(ev_j)
    assert ev.shape == (nk, 2, nb)
    assert np.max(np.abs(ev.numpy() - ev_j)) <= 1e-10
    # the two channels see different potentials
    assert np.max(np.abs(ev_j[:, 0] - ev_j[:, 1])) > 1e-4
    assert residual_health(rn)[1]
    # the beta density matrix of both channels from the same bands
    xj = np.asarray(xr) + 1j * np.asarray(xi)
    occ_w = np.random.default_rng(15).uniform(0.0, 0.1, (nk, 2, nb))
    beta = np.asarray(jctx.beta.beta_gk) * np.asarray(jctx.gkvec.mask)[:, None]
    dr, di = jax_dm_kset(*map(jnp.asarray, split_cplx(beta)),
                         *map(jnp.asarray, split_cplx(xj)), jnp.asarray(occ_w))
    want = np.asarray(dr) + 1j * np.asarray(di)
    got = density_matrix_kset(torch.as_tensor(beta), psi_from_numpy(xj, "cpu"),
                              torch.as_tensor(occ_w))
    assert got.shape == want.shape == (2,) + jctx.beta.dion.shape
    assert np.max(np.abs(got.numpy() - want)) <= 1e-12 * np.max(np.abs(want))


def test_davidson_residual_plain_semantics():
    rng = np.random.default_rng(4)
    b, nb, ngk = 2, 3, 16
    c = lambda: torch.as_tensor(rng.standard_normal((b, nb, ngk))  # noqa: E731
                                + 1j * rng.standard_normal((b, nb, ngk)))
    x, hx, sx = c(), c(), c()
    hx[0, 1] = 1.5 * sx[0, 1]  # exact eigenpair -> converged row, w = 0
    x[0, 1] = sx[0, 1]
    mask = torch.ones((b, ngk), dtype=torch.float64)
    mask[:, -3:] = 0.0
    hd = torch.as_tensor(rng.uniform(1, 3, (b, ngk)))
    od = torch.ones((b, ngk), dtype=torch.float64)
    ev, rn, w = davidson_residual(x, hx, sx, hd, od, mask, 1e-8)
    assert abs(float(ev[0, 1]) - 1.5) < 1e-14
    assert float(rn[0, 1]) < 1e-12
    assert torch.count_nonzero(w[0, 1]) == 0
    assert torch.count_nonzero(w[..., -3:]) == 0
    num = torch.sum(x.conj() * hx, -1).real
    den = torch.sum(x.conj() * sx, -1).real
    torch.testing.assert_close(ev, num / den, rtol=1e-14, atol=0)


def test_num_applies():
    assert num_applies(20, 8) == 8 * (20 + 8)


@pytest.mark.parametrize("ndrop", [0, 3])
def test_rayleigh_ritz_matches_jax_when_rank_deficient(ndrop):
    # a subspace with ndrop exactly dependent vectors: the kept block's
    # lowest Ritz pairs equal the JAX package's (fixed 1e6 shift) although
    # the port shifts the dropped directions only above the kept block's
    # Gershgorin bound
    from sirius_tpu.solvers.davidson import _rayleigh_ritz as jax_rr
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    rng = np.random.default_rng(60 + ndrop)
    n, m, nev = 40, 12, 5
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = a + a.conj().T + 8.0 * np.eye(n)
    v = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    if ndrop:
        v[-ndrop:] = rng.standard_normal((ndrop, m - ndrop)) @ v[:m - ndrop]
    hsub = v.conj() @ h @ v.T
    ssub = v.conj() @ v.T
    hsub, ssub = 0.5 * (hsub + hsub.conj().T), 0.5 * (ssub + ssub.conj().T)
    je, jc = (np.asarray(x) for x in jax_rr(jnp.asarray(hsub), jnp.asarray(ssub), nev))
    e, c = (x[0].numpy() for x in _rayleigh_ritz(
        torch.as_tensor(hsub)[None], torch.as_tensor(ssub)[None], nev))
    assert np.max(np.abs(e - je)) <= 1e-12 * np.max(np.abs(je))
    # the same Ritz vectors up to a phase each: |<x_port|S|x_jax>| = 1
    overlap = np.abs(np.einsum("mi,mn,ni->i", c.conj(), ssub, jc))
    assert np.max(np.abs(overlap - 1.0)) <= 1e-10


def empty_rows_matrix():
    """The S-subspace matrix [42, 42] complex128 on which cuSOLVER's heevd
    failed to converge in a fused run on the card: 12 zero rows (converged
    bands' empty residual rows) beside 14 eigenvalues within 1.1e-9 of 1."""
    return np.load(os.path.join(os.path.dirname(__file__), "data",
                                "eigh_empty_rows_ssub.npy"))


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64,
                                   torch.float64, torch.float32])
def test_eigh_jacobi_takes_lapack_on_the_cpu(dtype):
    # the card's retry of a failed eigh is torch.linalg.eigh on the CPU
    from sirius_tpu_torch.kernels.eigh_jacobi import eigh_jacobi

    s = empty_rows_matrix()
    a = torch.as_tensor(s if dtype.is_complex else s.real).to(dtype)
    a = torch.stack([a, 2.0 * a])
    e, v = eigh_jacobi(a)
    we, wv = torch.linalg.eigh(a)
    assert torch.equal(e, we) and torch.equal(v, wv)
    assert e.shape == (2, 42) and v.shape == (2, 42, 42)


def test_cpu_eigh_failure_is_not_retried(monkeypatch):
    # no host or Jacobi path on the CPU: LAPACK's failure is the caller's
    from sirius_tpu_torch.kernels import eigh_jacobi as mod
    from sirius_tpu_torch.solvers import davidson

    def fail(a):
        raise torch.linalg.LinAlgError("not converged")

    monkeypatch.setattr(davidson.torch.linalg, "eigh", fail)
    launches = mod.eigh_jacobi.launches
    with pytest.raises(torch.linalg.LinAlgError):
        davidson._eigh(torch.as_tensor(empty_rows_matrix())[None])
    assert mod.eigh_jacobi.launches == launches


@pytest.mark.parametrize("dtype", [np.complex64, np.float32, np.complex128,
                                   np.float64])
def test_rayleigh_ritz_reads_both_triangles(dtype):
    # the reduced matrix t^H H t is Hermitian only to rounding, and
    # jnp.linalg.eigh symmetrizes its input: a subspace pair whose H carries
    # an error in its lower triangle and one that carries the conjugate
    # error in its upper triangle have the same Hermitian average, so the
    # same Ritz values, in the port as in the JAX package, in every
    # precision (complex on the k-set paths, real on the packed Gamma path).
    # Reading one triangle set them apart by the error: in fp32 it let the
    # band solve's carried blocks drift, in fp64 it stalled the SCF's
    # density residual below 5e-9
    from sirius_tpu.solvers.davidson import _rayleigh_ritz as jax_rr
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    rng = np.random.default_rng(29)
    m, nev = 12, 5
    real = dtype == np.float32

    def draw():
        x = rng.standard_normal((m, m))
        return x if real else x + 1j * rng.standard_normal((m, m))

    a = draw()
    h = a + a.conj().T
    b = draw()
    s = b @ b.conj().T + m * np.eye(m)
    err = 1e-3 * np.tril(draw(), -1)
    lower, upper = h + err, h + err.conj().T
    got = [_rayleigh_ritz(torch.as_tensor(x.astype(dtype))[None],
                          torch.as_tensor(s.astype(dtype))[None], nev)[0][0]
           .double().numpy() for x in (lower, upper)]
    want = np.asarray(jax_rr(jnp.asarray(lower.astype(dtype)),
                             jnp.asarray(s.astype(dtype)), nev)[0],
                      dtype=np.float64)
    scale = np.max(np.abs(want))
    tol = 1e-5 if np.finfo(dtype).eps > 1e-10 else 1e-12
    assert np.max(np.abs(got[0] - got[1])) <= tol * scale
    assert np.max(np.abs(got[0] - want)) <= tol * scale


def fp32_subspace_pair(dtype, seed, n=60, m=16, ndrop=3):
    """A subspace pair built in float64 from m trial vectors of which ndrop
    are exact combinations of the others, cast to the working type."""
    rng = np.random.default_rng(seed)
    cplx = np.dtype(dtype).kind == "c"

    def draw(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cplx else x

    a = draw(n, n)
    h = a + a.conj().T + 8.0 * np.eye(n)
    v = draw(m, n)
    v[-ndrop:] = rng.standard_normal((ndrop, m - ndrop)) @ v[:m - ndrop]
    hsub = v.conj() @ h @ v.T
    ssub = v.conj() @ v.T
    hsub, ssub = 0.5 * (hsub + hsub.conj().T), 0.5 * (ssub + ssub.conj().T)
    return hsub.astype(dtype), ssub.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_rayleigh_ritz_fp32_keeps_the_jax_directions(dtype):
    # the fp32 band solves' subspaces, rank-deficient by construction: the
    # port returns the type it was given, with the JAX package's float32
    # Ritz pairs to fp32 rounding: eigenvalues to 2e-5 relative to the
    # largest, vectors to 1e-3 in |<x|S|x_jax>|
    from sirius_tpu.solvers.davidson import _rayleigh_ritz as jax_rr
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    nev = 5
    hsub, ssub = fp32_subspace_pair(dtype, 71)
    je, jc = (np.asarray(x) for x in jax_rr(jnp.asarray(hsub),
                                             jnp.asarray(ssub), nev))
    e, c = _rayleigh_ritz(torch.as_tensor(hsub)[None],
                          torch.as_tensor(ssub)[None], nev)
    assert e.dtype == torch.float32
    assert c.dtype == torch.as_tensor(ssub).dtype
    e, c = e[0].double().numpy(), c[0].numpy().astype(np.complex128)
    assert np.max(np.abs(e - je)) <= 2e-5 * np.max(np.abs(je))
    s64 = ssub.astype(np.complex128)
    overlap = np.abs(np.einsum("mi,mn,ni->i", c.conj(), s64,
                               jc.astype(np.complex128)))
    assert np.max(np.abs(overlap - 1.0)) <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_rayleigh_ritz_cutoff_takes_the_working_eps(dtype):
    # an overlap direction at 1e-6 of the largest: above the float64 cutoff
    # (max(50 eps, 1e-11) smax) and below float32's (50 eps = 6e-6 smax).
    # With H = -1 along it, keeping it gives a Ritz value near -1e6. A
    # float32 or complex64 pair drops it, as the JAX package's float32 solve
    # does; a float64 pair keeps it
    from sirius_tpu.solvers.davidson import _rayleigh_ritz as jax_rr
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    rng = np.random.default_rng(83)
    m = 8
    q, _ = np.linalg.qr(rng.standard_normal((m, m))
                        + 1j * rng.standard_normal((m, m)))
    if np.dtype(dtype).kind != "c":
        q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    s = np.r_[np.linspace(1.0, 2.0, m - 1), 1e-6]
    h = np.r_[np.linspace(-1.0, 1.0, m - 1), -1.0]
    ssub = (q * s) @ q.conj().T
    hsub = (q * h) @ q.conj().T
    hsub, ssub = hsub.astype(dtype), ssub.astype(dtype)
    e = _rayleigh_ritz(torch.as_tensor(hsub)[None],
                       torch.as_tensor(ssub)[None], 3)[0][0].double().numpy()
    je = np.asarray(jax_rr(jnp.asarray(hsub), jnp.asarray(ssub), 3)[0])
    if np.finfo(dtype).eps > 1e-10:
        assert e[0] > -2.0 and je[0] > -2.0
        assert np.max(np.abs(e - je)) <= 2e-5
    else:
        assert e[0] < -1e5 and je[0] < -1e5


@pytest.mark.parametrize("batch", [(), (3,)])
def test_padded_eigh_gives_the_leading_block(batch):
    # the card's route for float32 subspaces of order 32 to 512: padded to
    # order 513 with a diagonal block above the Gershgorin bound, eigh
    # returns the matrix's own eigenpairs (float32 rounding: 2e-6 of the
    # norm in the values, the vectors up to sign to 1e-4), in float32
    from sirius_tpu_torch.solvers.davidson import SYEVJ_MAX, eigh_padded

    rng = np.random.default_rng(7)
    v = rng.standard_normal(batch + (129, 260))
    a = torch.as_tensor(v @ np.swapaxes(v, -1, -2) / 260.0 - 0.5 * np.eye(129),
                        dtype=torch.float32)
    e, u = eigh_padded(a, SYEVJ_MAX + 1)
    want_e, want_u = torch.linalg.eigh(a.double())
    assert e.dtype == u.dtype == torch.float32
    assert e.shape == a.shape[:-1] and u.shape == a.shape
    scale = float(want_e.abs().max())
    assert float((e.double() - want_e).abs().max()) <= 2e-6 * scale
    # well separated ends of the spectrum: vectors defined up to sign
    for k in (0, 1, -1):
        dot = (u[..., k].double() * want_u[..., k]).sum(-1).abs()
        assert float((dot - 1.0).abs().max()) <= 1e-4


def test_only_float32_on_the_card_takes_the_padded_route():
    from sirius_tpu_torch.solvers.davidson import SYEVJ_MAX, takes_syevj

    class Card:
        def __init__(self, dtype, n):
            self.device = torch.device("cuda")
            self.dtype = dtype
            self.shape = (1, n, n)

    assert takes_syevj(Card(torch.float32, 387))
    assert takes_syevj(Card(torch.float32, 32))
    assert takes_syevj(Card(torch.float32, SYEVJ_MAX))
    assert not takes_syevj(Card(torch.float32, 31))
    assert not takes_syevj(Card(torch.float32, SYEVJ_MAX + 1))
    for dtype in (torch.complex64, torch.float64, torch.complex128):
        assert not takes_syevj(Card(dtype, 387))
    assert not takes_syevj(torch.zeros(1, 387, 387, dtype=torch.float32))


def test_only_large_orders_are_padded(monkeypatch):
    # on the card, among the matrices Jacobi would take, those of order
    # PAD_FROM or more are padded; smaller ones stay Jacobi's
    import sirius_tpu_torch.solvers.davidson  # noqa: F401
    mod = sys.modules["sirius_tpu_torch.solvers.davidson"]

    padded = []
    monkeypatch.setattr(mod, "takes_syevj", lambda a: True)
    monkeypatch.setattr(mod, "eigh_padded",
                        lambda a, m: padded.append(a.shape[-1]) or
                        torch.linalg.eigh(a))
    for n in (mod.PAD_FROM - 1, mod.PAD_FROM):
        mod._eigh(torch.eye(n, dtype=torch.float32)[None])
    assert padded == [mod.PAD_FROM]
