"""Port parity for the non-collinear (num_mag_dims 3) ground state: each
module that holds a kernel against the JAX package on the CPU, on the small
ultrasoft cell of tests/test_noncollinear.py (gk 3.5 / pw 9, 16 spinor
bands), from numpy inputs made with a fixed seed:

- the spinor operator (ops/spinor.py::apply_h_s_nc with K12a and K1 on
  their plain versions) with random, non-symmetric and non-Hermitian D and
  Q blocks (a transposed or swapped ud / du block shows), at the 4 k-points
  of the 6-op deck; the band solve (davidson_kset_nc) from the JAX
  package's start spinors; the four-component density (K12b) and the spin
  density matrix;
- the axial-vector symmetrization (K6v) on random vector fields under the
  6-op group of canted moments and the 8-op group of z moments, and the
  non-collinear density-matrix symmetrization;
- the potential (generate_potential_nc) for LDA and PBE, with and without
  symmetry, on magnetizations whose |m| crosses the 1e-8 guard of m-hat
  and exceeds rho_xc;
- run_scf on the two tier-1 decks against the JAX package's recorded
  results (sirius_tpu_torch/data/jax_reference.json), and the physics
  invariants of tests/test_noncollinear.py on the port.

Bounds: operators 1e-12 relative to the largest magnitude of each output,
the band solve's eigenvalues 1e-10 Ha (40 steps, as tests/
test_torch_davidson.py), SCF energy terms and E_F 1e-8 Ha, moments 1e-8,
the electron count 1e-10, the same iteration count."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft import density as jden
from sirius_tpu.dft import potential_nc as jpot
from sirius_tpu.dft.scf_nc import _dm_component_blocks as jax_dm_blocks
from sirius_tpu.dft.scf_nc import _initial_spinors as jax_initial_spinors
from sirius_tpu.dft.xc import XCFunctional as JaxXC
from sirius_tpu.ops import spinor as jspinor
from sirius_tpu.parallel import batched_nc as jbnc
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.convert import (NC_SET_KEYS, nc_set_from_numpy,
                                      nc_state_from_numpy)
from sirius_tpu_torch.dft import density as tden
from sirius_tpu_torch.dft import potential_nc as tpot
from sirius_tpu_torch.dft.density import dm_component_blocks
from sirius_tpu_torch.dft.scf import band_solve_path, run_scf
from sirius_tpu_torch.dft.scf_nc import _initial_spinors
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels import density_accumulate_nc as k12b
from sirius_tpu_torch.kernels import spinor_veff as k12a
from sirius_tpu_torch.kernels import symmetrize_pw as k6
from sirius_tpu_torch.ops import spinor as tspinor
from sirius_tpu_torch.parallel import batched_nc as tbnc
from sirius_tpu_torch.solvers.davidson import num_applies
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "sirius_tpu_torch", "data", "jax_reference.json")
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
SHAPE = dict(gk_cutoff=3.5, pw_cutoff=9.0, ngridk=(2, 2, 2), num_bands=16,
             ultrasoft=True)
CANTED = [[0.3, 0.3, 0.3], [0.3, 0.3, 0.3]]
Z_FM = [[0.0, 0.0, 0.5], [0.0, 0.0, 0.5]]
# the tier-1 decks of tools/torch_port_reference.py
TIER1 = ("small_spinor_us", "small_spinor_pbe_us_sym")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def contexts(moments=CANTED, use_symmetry=True, **params):
    kw = dict(SHAPE, use_symmetry=use_symmetry, moments=np.asarray(moments),
              extra_params={"num_mag_dims": 3, **params})
    return jax_context(**kw), port_context(**kw)


@pytest.fixture(scope="module")
def canted():
    jctx, pctx = contexts()
    assert jctx.symmetry.num_ops == pctx.symmetry.num_ops == 6
    assert jctx.gkvec.num_kpoints == pctx.gkvec.num_kpoints == 4
    return jctx, pctx


@pytest.fixture(scope="module")
def z_fm():
    jctx, pctx = contexts(Z_FM)
    assert jctx.symmetry.num_ops == pctx.symmetry.num_ops == 8
    return jctx, pctx


def random_operator(ctx, seed=3):
    """Coarse boxes (v_uu, v_dd, bx, by) and random complex D and Q blocks,
    none of them symmetric or Hermitian."""
    rng = np.random.default_rng(seed)
    dims = tuple(ctx.fft_coarse.dims)
    nbeta = ctx.beta.num_beta_total
    boxes = np.stack([rng.uniform(-1.0, 0.5, dims) for _ in range(4)])
    boxes[2:] *= 0.3

    def blocks(scale):
        return scale * (rng.standard_normal((4, nbeta, nbeta))
                        + 1j * rng.standard_normal((4, nbeta, nbeta)))

    return boxes, blocks(0.4), blocks(0.05)


def test_moments_pass_through_both_helpers(canted):
    # the port's helper keeps 3-vector moments as the JAX helper does
    jctx, pctx = canted
    np.testing.assert_array_equal(pctx.unit_cell.moments, np.asarray(CANTED))
    np.testing.assert_array_equal(pctx.unit_cell.moments,
                                  jctx.unit_cell.moments)
    assert pctx.num_mag_dims == 3 and pctx.max_occupancy == 1.0
    assert band_solve_path(pctx.cfg, pctx) == "kset_nc"


@pytest.mark.parametrize("ngridk", [(1, 1, 1), (2, 2, 2)])
def test_gamma_and_kset_decks_take_the_spinor_solve(ngridk):
    # the JAX package hands a non-collinear deck to run_scf_nc before the
    # Gamma and chunked branches (scf.py:244-259)
    _, pctx = contexts(use_symmetry=False, ngridk=ngridk)
    for control in ({}, {"beta_chunked": True}):
        for key, value in control.items():
            setattr(pctx.cfg.control, key, value)
        assert band_solve_path(pctx.cfg, pctx) == "kset_nc"


def test_apply_h_s_nc_matches_jax(canted):
    jctx, pctx = canted
    boxes, dmat, qmat = random_operator(jctx)
    rng = np.random.default_rng(5)
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = rng.standard_normal((nk, 6, 2 * ngk)) \
        + 1j * rng.standard_normal((nk, 6, 2 * ngk))
    want_h, want_s = [], []
    for ik in range(nk):
        prm = jspinor.NcHkParams(
            *(jnp.asarray(b) for b in boxes),
            ekin=jnp.asarray(jctx.gkvec.kinetic()[ik]),
            mask=jnp.asarray(jctx.gkvec.mask[ik]),
            fft_index=jnp.asarray(jctx.gkvec.fft_index[ik]),
            beta=jnp.asarray(jctx.beta.beta_gk[ik]), dmat=jnp.asarray(dmat),
            qmat=jnp.asarray(qmat))
        h, s = jspinor.apply_h_s_nc(prm, jnp.asarray(psi[ik]))
        want_h.append(np.asarray(h))
        want_s.append(np.asarray(s))
    ps = tbnc.make_nc_set_params(pctx, boxes, dmat, qmat, device="cpu")
    calls = tspinor.apply_h_s_nc.calls
    h, s = tspinor.apply_h_s_nc(ps, torch.as_tensor(psi))
    assert tspinor.apply_h_s_nc.calls == calls + 1
    assert rel(h.numpy(), np.stack(want_h)) <= 1e-12
    assert rel(s.numpy(), np.stack(want_s)) <= 1e-12
    # the ud / du blocks matter: swapping them changes H psi
    swapped = dataclasses.replace(ps, dmat=ps.dmat[[0, 1, 3, 2]])
    h2, _ = tspinor.apply_h_s_nc(swapped, torch.as_tensor(psi))
    assert rel(h2.numpy(), np.stack(want_h)) > 1e-3


def test_spin_blocks_match_jax():
    # the (uu, dd, ud, du) assembly from non-symmetric component integrals
    rng = np.random.default_rng(7)
    d0, dz, dx, dy = rng.standard_normal((4, 6, 6))
    want = jspinor.spin_blocks_from_components(d0, dz, dx, dy)
    got = tspinor.spin_blocks_from_components(*torch.as_tensor(np.stack([d0, dz, dx,
                                                                dy])))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spinor_veff_plain_matches_jax_expression():
    # K12a's plain version against the JAX package's arithmetic
    # (spinor.py:64-67), with a point of zero B and one of pure B_y
    rng = np.random.default_rng(9)
    rows, n = 5, 64
    fr = rng.standard_normal((rows, 2, n)) + 1j * rng.standard_normal((rows, 2, n))
    v = rng.standard_normal((4, n))
    v[2:, 0] = 0.0
    v[2, 1] = 0.0
    bmix = v[2] - 1j * v[3]
    want = np.stack([fr[:, 0] * v[0] + fr[:, 1] * bmix,
                     fr[:, 1] * v[1] + fr[:, 0] * np.conj(bmix)], axis=1)
    got = k12a.spinor_veff(torch.as_tensor(fr), *torch.as_tensor(v))
    assert rel(got.numpy(), want) <= 1e-15
    with pytest.raises(ValueError, match="rows, 2, n"):
        k12a.spinor_veff(torch.as_tensor(fr[:, :1]).contiguous(),
                         *torch.as_tensor(v))


def jax_nc_set(jctx, boxes, dmat):
    return jbnc.make_nc_set_params(jctx, tuple(boxes), dmat, v0=-0.2)


def test_davidson_kset_nc_matches_jax(canted):
    jctx, pctx = canted
    boxes, dmat, _ = random_operator(jctx)
    # a Hermitian D (the band solve needs a Hermitian H)
    dmat = 0.5 * (dmat + dmat[[0, 1, 3, 2]].conj().transpose(0, 2, 1))
    dmat[:2] = dmat[:2].real
    jps = jax_nc_set(jctx, boxes, dmat)
    leaves = {k: np.asarray(getattr(jps, k)) for k in NC_SET_KEYS}
    ps = nc_set_from_numpy(leaves, "cpu")
    ps_direct = tbnc.make_nc_set_params(pctx, boxes, dmat, v0=-0.2,
                                        device="cpu")
    assert rel(ps_direct.h_diag.numpy(), leaves["h_diag"]) <= 1e-12
    assert rel(ps_direct.o_diag.numpy(), leaves["o_diag"]) <= 1e-12
    psi0 = jax_initial_spinors(jctx)
    np.testing.assert_array_equal(_initial_spinors(pctx), psi0)
    ev_j, pr, pi_, _ = jbnc.davidson_kset_nc(
        jps, jnp.asarray(psi0.real), jnp.asarray(psi0.imag), num_steps=40,
        res_tol=1e-12)
    psi = torch.as_tensor(psi0)
    ev, x, rn = tbnc.davidson_kset_nc(ps, psi, num_steps=40, res_tol=1e-12)
    assert ev.shape == (4, 16) and x.shape == psi.shape
    assert np.max(np.abs(ev.numpy() - np.asarray(ev_j))) <= 1e-10


def test_nc_state_from_numpy_splits_the_mixed_vector(canted):
    # the JAX package's packing [rho; m_x; m_y; m_z] (scf_nc.py:170-174);
    # one JAX state fed to both packages: the density of its spinors and
    # the potential of its mixed vector agree
    jctx, pctx = canted
    ng = jctx.gvec.num_gvec
    rho = jden.initial_density_g(jctx)
    m = jden.initial_magnetization_vec_g(jctx)
    x = np.concatenate([rho, m[0], m[1], m[2]])
    psi0 = jax_initial_spinors(jctx)
    psi, rho_t, m_t = nc_state_from_numpy(psi0, x, ng, "cpu")
    np.testing.assert_array_equal(psi.numpy(), psi0)
    np.testing.assert_array_equal(rho_t.numpy(), rho)
    np.testing.assert_array_equal(m_t.numpy(), m)
    with pytest.raises(ValueError, match="mixed vector"):
        nc_state_from_numpy(psi0, x[:-1], ng, "cpu")
    boxes, dmat, _ = random_operator(jctx)
    occ_w = np.random.default_rng(19).uniform(0.0, 0.3, psi0.shape[:2])
    want = np.asarray(jbnc.density_kset_nc(
        jax_nc_set(jctx, boxes, dmat), jnp.asarray(psi0.real),
        jnp.asarray(psi0.imag), jnp.asarray(occ_w)))
    got = tbnc.density_kset_nc(
        tbnc.make_nc_set_params(pctx, boxes, dmat, device="cpu"), psi,
        torch.as_tensor(occ_w))
    assert rel(got.numpy(), want) <= 1e-12
    names = ["XC_LDA_X", "XC_LDA_C_PZ"]
    want = jpot.generate_potential_nc(jctx, x[:ng], JaxXC(names),
                                      x[ng:].reshape(3, ng))
    got = tpot.generate_potential_nc(pctx, rho_t, XCFunctional(names), m_t,
                                     tden.grid_tables(pctx, "cpu"))
    assert rel(got.veff_g.numpy(), want.veff_g) <= 1e-12
    assert rel(got.bvec_g.numpy(), want.bvec_g) <= 1e-12


def test_density_kset_nc_and_density_matrix_match_jax(canted):
    jctx, pctx = canted
    boxes, dmat, _ = random_operator(jctx)
    jps = jax_nc_set(jctx, boxes, dmat)
    ps = tbnc.make_nc_set_params(pctx, boxes, dmat, device="cpu")
    rng = np.random.default_rng(11)
    nk, nb, ngk = 4, 16, jctx.gkvec.ngk_max
    psi = (rng.standard_normal((nk, nb, 2 * ngk))
           + 1j * rng.standard_normal((nk, nb, 2 * ngk)))
    psi *= np.tile(jctx.gkvec.mask, 2)[:, None, :]
    occ_w = rng.uniform(0.0, 0.3, (nk, nb))
    want = np.asarray(jbnc.density_kset_nc(
        jps, jnp.asarray(psi.real), jnp.asarray(psi.imag),
        jnp.asarray(occ_w)))
    got = tbnc.density_kset_nc(ps, torch.as_tensor(psi), torch.as_tensor(occ_w))
    assert got.shape == want.shape == (4,) + tuple(jctx.fft_coarse.dims)
    for c in range(4):
        assert rel(got[c].numpy(), want[c]) <= 1e-12
    br, bi = (np.asarray(jctx.beta.beta_gk).real,
              np.asarray(jctx.beta.beta_gk).imag)
    dre, dim = jbnc.density_matrix_kset_nc(
        jnp.asarray(br), jnp.asarray(bi), jnp.asarray(psi.real),
        jnp.asarray(psi.imag), jnp.asarray(occ_w))
    want_dm = np.asarray(dre) + 1j * np.asarray(dim)
    got_dm = tbnc.density_matrix_kset_nc(ps.beta, torch.as_tensor(psi),
                                         torch.as_tensor(occ_w)).numpy()
    assert rel(got_dm, want_dm) <= 1e-12


def test_density_from_coarse_acc_takes_four_fields(canted):
    # the four (rho, m_z, m_x, m_y) boxes finish as four independent fields:
    # each row equals the field finished alone, and agrees with the JAX
    # package's density_from_coarse_acc
    jctx, pctx = canted
    rng = np.random.default_rng(37)
    acc = rng.standard_normal((4,) + tuple(pctx.fft_coarse.dims))
    tables = tden.grid_tables(pctx, "cpu")
    got = tden.density_from_coarse_acc(pctx, torch.as_tensor(acc), tables)
    assert got.shape == (4, pctx.gvec.num_gvec)
    for c in range(4):
        one = tden.density_from_coarse_acc(pctx, torch.as_tensor(acc[c:c + 1]),
                                           tables)
        assert rel(got[c].numpy(), one[0].numpy()) <= 1e-15
    want = np.asarray(jden.density_from_coarse_acc(jctx, acc))
    assert rel(got.numpy(), want) <= 1e-12


def test_density_accumulate_nc_plain_against_numpy():
    # K12b's plain version against the JAX package's expression
    # (batched_nc.py:146-152) on one k-point's box, scale n^2
    rng = np.random.default_rng(13)
    nb, n = 7, 50
    fr = rng.standard_normal((nb, 2, n)) + 1j * rng.standard_normal((nb, 2, n))
    w = rng.uniform(0.0, 1.0, nb)
    acc0 = rng.standard_normal((4, n))
    up = np.einsum("b,bx->x", w, np.abs(fr[:, 0]) ** 2)
    dn = np.einsum("b,bx->x", w, np.abs(fr[:, 1]) ** 2)
    z2 = np.einsum("b,bx->x", w, fr[:, 0] * np.conj(fr[:, 1]))
    want = acc0 + n ** 2 * np.stack([up + dn, up - dn, 2 * z2.real,
                                     -2 * z2.imag])
    got = k12b.density_accumulate_nc(torch.as_tensor(acc0.copy()),
                                     torch.as_tensor(fr), torch.as_tensor(w),
                                     float(n) ** 2)
    assert rel(got.numpy(), want) <= 1e-14


@pytest.mark.parametrize("group", ["canted", "z_fm"])
def test_symmetrize_vector_pw_matches_jax(group, request):
    jctx, pctx = request.getfixturevalue(group)
    rng = np.random.default_rng(17)
    ng = jctx.gvec.num_gvec
    m = rng.standard_normal((3, ng)) + 1j * rng.standard_normal((3, ng))
    want = jpot.symmetrize_vector_pw(jctx, m)
    tb = tden.build_sym_pw_tables(pctx, "cpu")
    calls = k6.symmetrize_vector_pw.launches
    got = tpot.symmetrize_vector_pw(tb, torch.as_tensor(m)).numpy()
    assert k6.symmetrize_vector_pw.launches == calls  # the plain version
    assert rel(got, want) <= 1e-13
    # an inverted rotation (R^T for R) is caught on random input
    bad = k6.symmetrize_vector_pw(torch.as_tensor(m), tb.millers, tb.lut,
                                  tb.rot, tb.trans,
                                  tb.srot.mT.contiguous(), tb.dims).numpy()
    if any(not np.allclose(op.rot_cart, op.rot_cart.T)
           for op in pctx.symmetry.ops):
        assert rel(bad, want) > 1e-3


@pytest.mark.parametrize("group", ["canted", "z_fm"])
def test_symmetrize_density_matrix_nc_matches_jax(group, request):
    jctx, pctx = request.getfixturevalue(group)
    rng = np.random.default_rng(19)
    nbeta = jctx.beta.num_beta_total

    def herm():
        a = rng.standard_normal((nbeta, nbeta)) + 1j * rng.standard_normal((nbeta, nbeta))
        return a + a.conj().T

    dm3 = np.stack([herm(), herm(),
                    rng.standard_normal((nbeta, nbeta))
                    + 1j * rng.standard_normal((nbeta, nbeta))])
    want = jden.symmetrize_density_matrix_nc(jctx, dm3)
    tb = tden.build_dm_sym_tables(pctx, "cpu")
    got = tden.symmetrize_density_matrix_nc_device(torch.as_tensor(dm3),
                                                   tb).numpy()
    assert rel(got, want) <= 1e-13


def test_dm_component_blocks_are_hermitian(canted):
    # K4 reads Re(dm): exact only for Hermitian blocks; the m_y block is
    # i (ud - ud^H)
    jctx, _ = canted
    rng = np.random.default_rng(23)
    nbeta = jctx.beta.num_beta_total
    a = rng.standard_normal((3, nbeta, nbeta)) \
        + 1j * rng.standard_normal((3, nbeta, nbeta))
    dm3 = np.stack([a[0] + a[0].conj().T, a[1] + a[1].conj().T, a[2]])
    got = dm_component_blocks(torch.as_tensor(dm3)).numpy()
    want = jax_dm_blocks(jctx, dm3)
    for i, key in enumerate(("rho", "mx", "my", "mz")):
        np.testing.assert_allclose(got[i], want[key], rtol=0, atol=1e-14)
        np.testing.assert_allclose(got[i], got[i].conj().T, rtol=0, atol=0)


def potential_inputs(jctx, scale, seed=29):
    """The free-atom density and a magnetization with a random direction
    field, scaled so that max |m(r)| is ``scale`` times max rho(r) (scale
    >= 1e-3), or ``scale`` itself (a nearly dead magnetization)."""
    rng = np.random.default_rng(seed)
    rho = jden.initial_density_g(jctx)
    m0 = jden.initial_magnetization_vec_g(jctx)
    mix = rng.standard_normal((3, 3))
    m = mix @ m0 + 0.2 * (m0[[1, 2, 0]] * (1 + 0.5j))
    m[:, 0] = m[:, 0].real
    m_r = np.stack([jpot._to_r(jctx, c) for c in m])
    rho_r = jpot._to_r(jctx, rho)
    top = scale * np.max(rho_r) if scale >= 1e-3 else scale
    m *= top / np.max(np.sqrt(np.sum(m_r ** 2, axis=0)))
    return rho, m


CASES = {
    "lda": (["XC_LDA_X", "XC_LDA_C_PZ"], 0.5),
    "lda_over_rho": (["XC_LDA_X", "XC_LDA_C_PZ"], 3.0),
    "pbe": (PBE, 0.5),
    "lda_dead_m": (["XC_LDA_X", "XC_LDA_C_PZ"], 3e-8),
    "pbe_dead_m": (PBE, 3e-8),
}


@pytest.mark.parametrize("use_symmetry", [True, False], ids=["sym", "nosym"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_potential_nc_matches_jax(canted, case, use_symmetry):
    jctx, pctx = canted
    names, scale = CASES[case]
    rho, m = potential_inputs(jctx, scale)
    if scale < 1e-6:
        # |m(r)| crosses the 1e-8 guard of m-hat inside the box
        m_len = np.sqrt(sum(jpot._to_r(jctx, c) ** 2 for c in m))
        assert np.sum(m_len > 1e-8) > 100 and np.sum(m_len < 1e-8) > 100
    jctx.cfg.parameters.use_symmetry = use_symmetry
    pctx.cfg.parameters.use_symmetry = use_symmetry
    try:
        want = jpot.generate_potential_nc(jctx, rho, JaxXC(names), m)
        tables = tden.grid_tables(pctx, "cpu")
        assert (tables.sym is not None) == use_symmetry
        got = tpot.generate_potential_nc(
            pctx, torch.as_tensor(rho), XCFunctional(names),
            torch.as_tensor(m), tables)
    finally:
        jctx.cfg.parameters.use_symmetry = True
        pctx.cfg.parameters.use_symmetry = True
    assert rel(got.veff_g.numpy(), want.veff_g) <= 1e-12
    assert rel(got.vxc_g.numpy(), want.vxc_g) <= 1e-12
    assert rel(got.vha_g.numpy(), want.vha_g) <= 1e-12
    # B = (v_up - v_dn)/2 along m-hat: where |m| is ~1e-8 the two channels'
    # potentials are equal to ~1e-8 and B carries their rounding (~1e-16
    # absolute); there it is held to the potential's scale
    dead = scale < 1e-6
    top = np.max(np.abs(want.veff_g))

    def close(a, b):
        if dead:
            return float(np.max(np.abs(a - b))) <= 1e-12 * top
        return rel(a, b) <= 1e-12

    assert close(got.bvec_g.numpy(), want.bvec_g)
    for c in range(4):
        assert close(got.veff_boxes[c].numpy(), np.asarray(want.veff_boxes[c])), c
    assert sorted(got.energies) == sorted(want.energies)
    for key, value in want.energies.items():
        assert abs(got.energies[key] - value) <= 1e-12, key


@pytest.fixture(scope="module")
def reference():
    with open(REF_PATH) as f:
        return json.load(f)["decks"]


def deck_context(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_reference",
        os.path.join(ROOT, "tools", "torch_port_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    shape, kind, control, params, moments = tool.deck_spec(name)
    assert control == {}
    return port_context(extra_params=dict(params), **kind, **shape,
                        moments=np.asarray(moments))


@pytest.mark.parametrize("deck", TIER1)
def test_tier1_deck_matches_jax(reference, deck):
    """run_scf on the Gamma-only LDA deck (no symmetry, orthogonal seeds)
    and the PBE deck with the 6-op group, each a fixed count past its
    convergence (14 and 20 iterations)."""
    ref = reference[deck]
    ctx = deck_context(deck)
    assert band_solve_path(ctx.cfg, ctx) == "kset_nc"
    calls = tspinor.apply_h_s_nc.calls
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert tspinor.apply_h_s_nc.calls > calls
    assert res["num_scf_iterations"] == ref["num_scf_iterations"]
    assert ref["num_scf_iterations"] == {"small_spinor_us": 14,
                                         "small_spinor_pbe_us_sym": 20}[deck]
    assert res["converged"] == ref["converged"]
    assert abs(res["efermi"] - ref["efermi"]) <= 1e-8
    assert sorted(res["energy"]) == sorted(ref["energy"])
    for key, want in ref["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    got, want = res["magnetisation"], ref["magnetisation"]
    assert np.max(np.abs(np.subtract(got["total"], want["total"]))) <= 1e-8
    assert np.max(np.abs(np.subtract(got["atoms"], want["atoms"]))) <= 1e-8
    # the deck is magnetic: a moment of order 1 along the relaxed axis
    assert np.linalg.norm(want["total"]) > 0.5
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    assert abs(nel - 8.0) <= 1e-10
    assert len(res["iteration_seconds"]) == res["num_scf_iterations"]


def test_noncollinear_loop_never_retries():
    # a residual over any blow-up bar and scf_supervision on: the JAX
    # non-collinear driver has no band-solve retry (scf_nc.py:187-210), so
    # the H applications are exactly one solve per iteration
    _, pctx = contexts(use_symmetry=False, ngridk=(1, 1, 1),
                       num_dft_iter=2)
    pctx.cfg.control.scf_supervision = True
    pctx.cfg.control.band_residual_blowup = 1e-30
    res = run_scf(pctx.cfg, ctx=pctx, device="cpu")
    steps = pctx.cfg.iterative_solver.num_steps
    assert res["counters"]["num_loc_op_applied"] == 2 * num_applies(steps, 16)


@pytest.mark.parametrize("key,value,match", [
    ("xc_functionals", ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"], "mGGA"),
    ("so_correction", True, "spin-orbit"),
    ("precision_wf", "fp32", "fp32"),
])
def test_noncollinear_refusals(key, value, match):
    # the JAX package's refusals (mGGA, scf_nc.py:103-106) and the port's
    # own (spin-orbit waits for UPF species, fp32 for its path)
    _, pctx = contexts(use_symmetry=False, ngridk=(1, 1, 1), num_dft_iter=1)
    setattr(pctx.cfg.parameters, key, value)
    with pytest.raises(NotImplementedError, match=match):
        run_scf(pctx.cfg, ctx=pctx, device="cpu")


def converged(moments, mag_dims, nb):
    ctx = port_context(gk_cutoff=3.5, pw_cutoff=9.0, ngridk=(1, 1, 1),
                       num_bands=nb, ultrasoft=True, use_symmetry=False,
                       moments=np.asarray(moments, float),
                       extra_params={"num_mag_dims": mag_dims,
                                     "smearing_width": 0.01,
                                     "density_tol": 1e-7, "energy_tol": 1e-8,
                                     "num_dft_iter": 60})
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["converged"]
    return res


@pytest.mark.slow
def test_z_moments_match_the_collinear_run():
    # the port's own spinor run with every moment along z reproduces its
    # collinear run (tests/test_noncollinear.py's invariant)
    z = [[0, 0, 0.5], [0, 0, 0.5]]
    col = converged(z, 1, 8)
    nc = converged(z, 3, 16)
    assert abs(nc["energy"]["total"] - col["energy"]["total"]) < 2e-6
    assert abs(nc["magnetisation"]["total"][2]
               - col["magnetisation"]["total"][2]) < 1e-4
    assert max(abs(x) for x in nc["magnetisation"]["total"][:2]) < 1e-6


@pytest.mark.slow
def test_energy_invariant_under_moment_rotation():
    r_z = converged([[0, 0, 0.5], [0, 0, 0.5]], 3, 16)
    r_x = converged([[0.5, 0, 0], [0.5, 0, 0]], 3, 16)
    assert abs(r_z["energy"]["total"] - r_x["energy"]["total"]) < 2e-6
    assert abs(r_x["magnetisation"]["total"][0]
               - r_z["magnetisation"]["total"][2]) < 1e-4
