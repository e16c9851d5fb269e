"""Port parity: the batched Davidson band solve (K2 residual and
preconditioner) and the LCAO subspace initialization against the JAX
package, from the same start block with the same num_steps, on the small
deck. num_steps is 40, where residuals are ~1e-10 and the occupied
projector is therefore defined to 1e-10. Compared: eigenvalues and the projector onto the occupied subspace
(the vectors' phases differ between LAPACK builds). Bound: 1e-10 Ha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import initial_density_g
from sirius_tpu.dft.potential import generate_potential
from sirius_tpu.dft.scf import _initial_subspace as jax_initial_subspace
from sirius_tpu.dft.xc import XCFunctional
from sirius_tpu.ops.hamiltonian import apply_h_s as jax_apply_h_s
from sirius_tpu.parallel.batched import davidson_kset as jax_davidson_kset
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import initialize_subspace_kset as jax_init
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.parallel.batched import split_cplx
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import HKSET_KEYS, hkset_from_numpy, psi_from_numpy
from sirius_tpu_torch.dft.scf import _initial_subspace as port_initial_subspace
from sirius_tpu_torch.kernels.davidson_residual import davidson_residual
from sirius_tpu_torch.ops.hamiltonian import apply_h_s
from sirius_tpu_torch.parallel.batched import davidson_kset, initialize_subspace_kset
from sirius_tpu_torch.solvers.davidson import num_applies, residual_health
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context

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
