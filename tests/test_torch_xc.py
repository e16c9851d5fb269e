"""Port parity: the XC energies and potentials of every LDA, GGA and SCAN
meta-GGA functional of the JAX package (K7 / K7b / K7g / K7s plain
versions) against its jax.grad values, polarized and unpolarized, on random
densities that include exactly-zero and sub-threshold (dead) channels,
fully polarized points and sigma = 0 points (and for SCAN alpha = 1
points). Bounds: LDA e and v 1e-12 relative, point by point; GGA and mGGA
e, v, vsigma, vtau and the flux fields 1e-12 relative to each output's
largest magnitude over the points (where the gradient correction cancels
the local term, PBE correlation's e and vsigma are rounding noise, 1e-16
and 1e-22, in both packages)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sirius_tpu.dft.xc as jax_xc
from sirius_tpu.dft.xc import XCFunctional as JaxXC
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels import xc_functionals as xf
from sirius_tpu_torch.kernels.gga_xc import gga_xc, gga_xc_unpolarized
from sirius_tpu_torch.kernels.lda_xc import lda_xc, lda_xc_unpolarized
from sirius_tpu_torch.kernels.mgga_xc import mgga_xc, mgga_xc_unpolarized
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

NAMES = ["XC_LDA_X", "XC_LDA_C_PZ"]
LDA_SUMS = [["XC_LDA_X"], ["XC_LDA_C_PZ"], ["XC_LDA_C_PW"], ["XC_LDA_C_VWN"],
            ["XC_LDA_X", "XC_LDA_C_PW"], ["XC_LDA_X", "XC_LDA_C_VWN"],
            ["XC_LDA_C_VWN", "XC_LDA_X", "XC_LDA_C_PW"]]
GGA_SUMS = [["XC_GGA_X_PBE"], ["XC_GGA_C_PBE"], ["XC_GGA_X_PBE_SOL"],
            ["XC_GGA_C_PBE_SOL"], ["XC_GGA_X_PBE", "XC_GGA_C_PBE"],
            ["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"],
            ["XC_GGA_X_PBE", "XC_LDA_C_PW"], ["XC_LDA_X", "XC_GGA_C_PBE"]]


def densities(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    nu = rng.uniform(0.0, 1.2, n) ** 3
    nd = rng.uniform(0.0, 1.2, n) ** 3
    nu[:50] = 0.0
    nd[25:75] = 0.0
    nu[100:150] = 1e-14  # below the 1e-13 dead-channel threshold
    nd[140:190] = 5e-14
    nu[200:250] = nd[200:250]  # unpolarized points
    nu[300:310] = 1e-13  # at the threshold
    return nu, nd


def assert_rel(got, want, bound=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= bound * np.abs(want)), float(np.max(err / np.maximum(np.abs(want), 1e-300)))


def assert_normwise(got, want, bound=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    err = float(np.max(np.abs(got - want)))
    assert err <= bound * float(np.max(np.abs(want))), err


def gradients(nu, nd, seed=3):
    """Gradient fields [3, n] of the two channels, consistent with sigma
    (sigma_ud^2 <= sigma_uu sigma_dd), with zero-gradient points and the
    dead points of densities()."""
    rng = np.random.default_rng(seed)
    n = len(nu)
    gu = rng.standard_normal((3, n)) * 0.3 * np.cbrt(nu)
    gd = rng.standard_normal((3, n)) * 0.3 * np.cbrt(nd)
    gu[:, 400:450] = 0.0
    gd[:, 420:470] = 0.0
    gu[:, 500:520] = gd[:, 500:520]
    return gu, gd


def sigmas(gu, gd):
    return ((gu * gu).sum(0), (gu * gd).sum(0), (gd * gd).sum(0))


def test_polarized_matches_jax():
    nu, nd = densities()
    want = JaxXC(NAMES).evaluate_polarized(jnp.asarray(nu), jnp.asarray(nd))
    got = XCFunctional(NAMES).evaluate_polarized(torch.as_tensor(nu),
                                                 torch.as_tensor(nd))
    for key in ("e", "v_up", "v_dn"):
        assert_rel(got[key].numpy(), want[key])
    # dead channels carry exactly zero potential
    assert np.all(got["v_up"].numpy()[:50] == 0.0)
    assert np.all(got["v_dn"].numpy()[140:190] == 0.0)


def test_unpolarized_matches_jax():
    nu, _ = densities(seed=1)
    rho = 2.0 * nu
    want = JaxXC(NAMES).evaluate(jnp.asarray(rho))
    got = XCFunctional(NAMES).evaluate(torch.as_tensor(rho))
    assert_rel(got["e"].numpy(), want["e"])
    assert_rel(got["v"].numpy(), want["v"])


def test_unpolarized_is_the_spin_average():
    nu, _ = densities(seed=2)
    t = torch.as_tensor(nu)
    e, v = lda_xc_unpolarized(2.0 * t)
    e2, vu, vd = lda_xc(t, t)
    torch.testing.assert_close(e, e2, rtol=0, atol=0)
    torch.testing.assert_close(v, 0.5 * (vu + vd), rtol=0, atol=0)


@pytest.mark.parametrize("names", [["XC_GGA_X_PBE", "XC_GGA_C_PBE"],
                                   ["XC_LDA_X", "XC_LDA_C_PW"],
                                   ["XC_LDA_X"]])
def test_other_functionals_not_in_slice(names):
    # these functionals were outside the first slices; they run now, and
    # agree with the JAX package polarized
    nu, nd = densities(seed=5)
    gu, gd = gradients(nu, nd)
    xc = XCFunctional(names)
    assert xc.is_gga == JaxXC(names).is_gga
    args = (nu, nd) + (sigmas(gu, gd) if xc.is_gga else ())
    want = JaxXC(names).evaluate_polarized(*map(jnp.asarray, args))
    got = xc.evaluate_polarized(*map(torch.as_tensor, args))
    assert sorted(got) == sorted(want)
    for key in got:
        (assert_normwise if xc.is_gga else assert_rel)(got[key].numpy(),
                                                       want[key])


@pytest.mark.parametrize("names", LDA_SUMS + GGA_SUMS,
                         ids=lambda n: "+".join(x[3:] for x in n))
def test_every_functional_matches_jax(names):
    """e, v and (GGA) vsigma, polarized and unpolarized."""
    nu, nd = densities(seed=6)
    gu, gd = gradients(nu, nd)
    suu, sud, sdd = sigmas(gu, gd)
    jxc, xc = JaxXC(names), XCFunctional(names)
    pol = (nu, nd, suu, sud, sdd) if xc.is_gga else (nu, nd)
    want = jxc.evaluate_polarized(*map(jnp.asarray, pol))
    got = xc.evaluate_polarized(*map(torch.as_tensor, pol))
    rho = nu + nd
    unp = (rho, ((gu + gd) ** 2).sum(0)) if xc.is_gga else (rho,)
    want_u = jxc.evaluate(*map(jnp.asarray, unp))
    got_u = xc.evaluate(*map(torch.as_tensor, unp))
    for g, w in ((got, want), (got_u, want_u)):
        assert sorted(g) == sorted(w)
        for key in g:
            (assert_normwise if xc.is_gga else assert_rel)(g[key].numpy(),
                                                           w[key])
    # dead channels carry exactly zero potential
    assert np.all(got["v_up"].numpy()[:50] == 0.0)
    assert np.all(got["v_dn"].numpy()[25:75] == 0.0)
    if xc.is_gga:
        assert np.all(got["vsigma_ud"].numpy()[:75] == 0.0)


@pytest.mark.parametrize("names", GGA_SUMS[4:],
                         ids=lambda n: "+".join(x[3:] for x in n))
def test_gga_flux_form_matches_jax(names):
    """The gradient form K7g computes (sigma formed from the gradients, the
    flux fields of the divergence term) against the JAX package's vsigma
    and the products of potential.py:132-137 and :155."""
    nu, nd = densities(seed=7)
    gu, gd = gradients(nu, nd, seed=8)
    suu, sud, sdd = (sum(a * b for a, b in zip(x, y))
                     for x, y in ((gu, gu), (gu, gd), (gd, gd)))
    w = JaxXC(names).evaluate_polarized(*map(jnp.asarray,
                                             (nu, nd, suu, sud, sdd)))
    vsuu, vsud, vsdd = (np.asarray(w[k]) for k in
                        ("vsigma_uu", "vsigma_ud", "vsigma_dd"))
    e, vu, vd, fu, fd = gga_xc(*map(torch.as_tensor, (nu, nd, gu, gd)), names)
    assert_normwise(e.numpy(), w["e"])
    assert_normwise(vu.numpy(), w["v_up"])
    assert_normwise(vd.numpy(), w["v_dn"])
    assert_normwise(fu.numpy(), 2 * vsuu * gu + vsud * gd)
    assert_normwise(fd.numpy(), 2 * vsdd * gd + vsud * gu)
    rho = nu + nd
    g = gu + gd
    sigma = g[0] ** 2 + g[1] ** 2 + g[2] ** 2
    w = JaxXC(names).evaluate(jnp.asarray(rho), jnp.asarray(sigma))
    e, v, f = gga_xc_unpolarized(torch.as_tensor(rho), torch.as_tensor(g),
                                 names)
    assert_normwise(e.numpy(), w["e"])
    assert_normwise(v.numpy(), w["v"])
    assert_normwise(f.numpy(), 2.0 * np.asarray(w["vsigma"]) * g)


def test_constants_match_jax_bit_for_bit():
    for name in ("TINY", "DENS_TH", "PBE_KAPPA", "PBE_MU", "PBE_BETA",
                 "PBE_GAMMA", "PBESOL_MU", "PBESOL_BETA"):
        want = float(getattr(jax_xc, "_" + name))
        assert getattr(xf, name) == want, name
    assert xf.PBE_GAMMA == (1.0 - math.log(2.0)) / math.pi**2


def test_pw92_and_pw_mod_differ():
    # XC_LDA_C_PW takes the published PW92 digits; PBE correlation is
    # defined on PW_MOD. The two differ at ~1e-5 relative, far above the
    # parity bound, so a swap would show
    nu, nd = densities(seed=9)
    t = torch.as_tensor
    pub = xf.lda_c_pw_e(t(nu), t(nd)).numpy()
    mod = xf.lda_c_pw_e(t(nu), t(nd), mod=True).numpy()
    live = nu + nd > 1e-6
    rel = np.abs(pub - mod)[live] / np.abs(mod)[live]
    assert np.median(rel) > 1e-6 and rel.max() < 1e-3
    want_pub = jax_xc._lda_c_pw_e(jnp.asarray(nu), jnp.asarray(nd))
    want_mod = jax_xc._lda_c_pw_e(jnp.asarray(nu), jnp.asarray(nd), mod=True)
    assert_rel(pub[live], np.asarray(want_pub)[live])
    assert_rel(mod[live], np.asarray(want_mod)[live])


SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
MGGA_SUMS = [SCAN, ["XC_MGGA_X_SCAN"], ["XC_MGGA_C_SCAN"],
             ["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"],
             ["XC_MGGA_X_SCAN", "XC_LDA_C_PW"]]
TAU_UNIF = 0.3 * (6.0 * np.pi**2) ** (2.0 / 3.0)


def scan_inputs(seed=12, n=4000):
    """Densities with dead channels and fully polarized points, gradients
    with zero-gradient (s = 0) points, and per-spin tau: random multiples
    of the uniform-gas value plus the von Weizsaecker term, with alpha = 1
    exactly at some points, alpha within 1e-9 of 1 at others, and tau = 0
    (the first SCF potential's) at others."""
    nu, nd = densities(seed=seed, n=n)
    gu, gd = gradients(nu, nd, seed=seed + 1)
    suu, sud, sdd = sigmas(gu, gd)
    rng = np.random.default_rng(seed + 2)

    def tau(n_s, s_ss):
        t = TAU_UNIF * n_s ** (5.0 / 3.0) * rng.uniform(0.1, 3.0, n)
        t[600:650] = TAU_UNIF * n_s[600:650] ** (5.0 / 3.0)  # alpha = 1
        t[650:700] *= 0.0
        t[700:750] = TAU_UNIF * n_s[700:750] ** (5.0 / 3.0) * (1 + 1e-9)
        return t + s_ss / np.maximum(8.0 * n_s, 1e-30)

    return nu, nd, gu, gd, suu, sud, sdd, tau(nu, suu), tau(nd, sdd)


def assert_dicts_normwise(got, want):
    assert sorted(got) == sorted(want)
    for key in got:
        assert_normwise(got[key].numpy(), want[key])


@pytest.mark.parametrize("names", [["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"],
                                   ["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"]])
def test_scan_not_in_slice(names):
    # SCAN was outside the earlier slices; it runs now, alone and mixed
    # with a GGA name, and agrees with the JAX package polarized and
    # unpolarized (vtau included)
    xc, jxc = XCFunctional(names), JaxXC(names)
    assert xc.is_mgga and xc.is_gga
    assert (xc.is_mgga, xc.is_gga) == (jxc.is_mgga, jxc.is_gga)
    nu, nd, gu, gd, suu, sud, sdd, tu, td = scan_inputs(seed=21)
    pol = (nu, nd, suu, sud, sdd)
    want = jxc.evaluate_polarized(*map(jnp.asarray, pol),
                                  tau_up=jnp.asarray(tu),
                                  tau_dn=jnp.asarray(td))
    got = xc.evaluate_polarized(*map(torch.as_tensor, pol),
                                tau_up=torch.as_tensor(tu),
                                tau_dn=torch.as_tensor(td))
    assert_dicts_normwise(got, want)
    unp = (nu + nd, ((gu + gd) ** 2).sum(0), tu + td)
    assert_dicts_normwise(xc.evaluate(*map(torch.as_tensor, unp)),
                          jxc.evaluate(*map(jnp.asarray, unp)))


@pytest.mark.parametrize("names", MGGA_SUMS,
                         ids=lambda n: "+".join(x[3:] for x in n))
def test_scan_matches_jax(names):
    """e, v, vsigma and vtau polarized and unpolarized, and the gradient
    form K7s computes (sigma from the gradients, the flux fields, vtau)."""
    nu, nd, gu, gd, suu, sud, sdd, tu, td = scan_inputs()
    jxc = JaxXC(names)
    w = jxc.evaluate_polarized(*map(jnp.asarray, (nu, nd, suu, sud, sdd)),
                               tau_up=jnp.asarray(tu), tau_dn=jnp.asarray(td))
    e, vu, vd, fu, fd, vtu, vtd = mgga_xc(
        *map(torch.as_tensor, (nu, nd, gu, gd, tu, td)), names)
    vsuu, vsud, vsdd = (np.asarray(w[k]) for k in
                        ("vsigma_uu", "vsigma_ud", "vsigma_dd"))
    for got, want in ((e, w["e"]), (vu, w["v_up"]), (vd, w["v_dn"]),
                      (vtu, w["vtau_up"]), (vtd, w["vtau_dn"]),
                      (fu, 2 * vsuu * gu + vsud * gd),
                      (fd, 2 * vsdd * gd + vsud * gu)):
        assert_normwise(got.numpy(), want)
    # dead channels carry exactly zero potential, vtau included
    for t in (vu, vtu):
        assert np.all(t.numpy()[:50] == 0.0)
    for t in (vd, vtd):
        assert np.all(t.numpy()[25:75] == 0.0)
    rho, g, tau = nu + nd, gu + gd, tu + td
    w = jxc.evaluate(jnp.asarray(rho), jnp.asarray((g * g).sum(0)),
                     tau=jnp.asarray(tau))
    e, v, f, vt = mgga_xc_unpolarized(*map(torch.as_tensor, (rho, g, tau)),
                                      names)
    assert_normwise(e.numpy(), w["e"])
    assert_normwise(v.numpy(), w["v"])
    assert_normwise(vt.numpy(), w["vtau"])
    assert_normwise(f.numpy(), 2.0 * np.asarray(w["vsigma"]) * g)


def test_scan_uniform_gas_reduces_to_lsda():
    # at s = 0 and alpha = 1 SCAN is exactly LSDA exchange + PW92-mod
    # correlation (tests/test_mgga.py:18-32)
    rng = np.random.default_rng(7)
    n = rng.uniform(0.01, 2.0, 40)
    zeta = rng.uniform(-0.9, 0.9, 40)
    nu, nd = 0.5 * n * (1 + zeta), 0.5 * n * (1 - zeta)
    t = torch.as_tensor
    z = torch.zeros(40, dtype=torch.float64)
    e = xf.energy(SCAN, t(nu), t(nd), z, z, z, t(TAU_UNIF * nu ** (5 / 3)),
                  t(TAU_UNIF * nd ** (5 / 3))).numpy()
    e_lsda = (xf.lda_x_e(t(nu), t(nd))
              + xf.lda_c_pw_e(t(nu), t(nd), mod=True)).numpy()
    np.testing.assert_allclose(e, e_lsda, rtol=2e-6)


def test_scan_potentials_finite():
    # over a wide (n, s, alpha) range including the alpha ~ 1 boundary
    # (tests/test_mgga.py:35-55)
    rng = np.random.default_rng(3)
    m = 200
    nu, nd = rng.uniform(1e-6, 5.0, m), rng.uniform(1e-6, 5.0, m)
    suu, sdd = rng.uniform(0.0, 10.0, m), rng.uniform(0.0, 10.0, m)
    sud = np.sqrt(suu * sdd) * 0.5
    tu, td = rng.uniform(1e-8, 20.0, m), rng.uniform(1e-8, 20.0, m)
    out = XCFunctional(SCAN).evaluate_polarized(
        *map(torch.as_tensor, (nu, nd, suu, sud, sdd)),
        tau_up=torch.as_tensor(tu), tau_dn=torch.as_tensor(td))
    for key in ("e", "v_up", "v_dn", "vsigma_uu", "vtau_up", "vtau_dn"):
        assert torch.all(torch.isfinite(out[key])), key
    ex = xf.energy(["XC_MGGA_X_SCAN"], *map(torch.as_tensor,
                                            (nu, nd, suu, sud, sdd, tu, td)))
    assert torch.all(ex < 0)


def test_scan_constants_match_jax_bit_for_bit():
    for name in ("K1", "MU", "B1", "B2", "B3", "B4", "H0X", "A1", "C1X",
                 "C2X", "DX", "C1C", "C2C", "DC", "B1C", "B2C", "B3C", "CHI",
                 "GAMMA"):
        want = float(getattr(jax_xc, "_SCAN_" + name))
        assert getattr(xf, "SCAN_" + name) == want, name


def test_gga_kernel_refuses_scan_and_mgga_needs_it():
    t = torch.ones(4, dtype=torch.float64)
    g = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="mgga_xc"):
        gga_xc(t, t, g, g, ["XC_GGA_X_PBE", "XC_MGGA_C_SCAN"])
    with pytest.raises(ValueError, match="SCAN"):
        mgga_xc(t, t, g, g, t, t, ["XC_GGA_X_PBE"])


def test_gga_from_sigma_is_the_plain_version_only():
    # on the card GGA runs from gradients (K7g); the sigma form is the
    # plain autograd version and refuses any other device
    xc = XCFunctional(["XC_GGA_X_PBE", "XC_GGA_C_PBE"])
    x = torch.ones(4, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="evaluate_gga"):
        xc.evaluate(x, x)
    with pytest.raises(ValueError, match="LDA"):
        lda_xc(torch.ones(4, dtype=torch.float64),
               torch.ones(4, dtype=torch.float64), ["XC_GGA_X_PBE"])


def test_unknown_functional_is_an_error():
    with pytest.raises(ValueError):
        XCFunctional(["XC_NOT_A_FUNCTIONAL"])


def test_kernel_wrapper_checks_dtype():
    with pytest.raises(ValueError):
        lda_xc(torch.ones(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32))
