"""The derivative structure and the instantiations of the compiled XC sets
of K7g and K7s (csrc/xc_sets.cuh), off the card.

K7g's PBE and PBEsol instantiations take each exchange half as a function
of (n_s, sigma_ss) and correlation as a function of (n_up, n_dn, sigma =
sigma_uu + 2 sigma_ud + sigma_dd), and chain the partials back with the
weights (1, 2, 1). Here the same decomposition, on the port's plain energy
expressions under torch.autograd, is held against jax.grad of the JAX
package's energies (its dead-channel handling included) to 1e-13 relative
to each output's largest magnitude. The wrappers' choice of instantiation
is held on every legal functional list, and the constants xc_sets.cuh
writes as literals against the values the JAX package derives."""

import itertools
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sirius_tpu.dft.xc as jax_xc
from sirius_tpu_torch.kernels import gga_xc as k7g
from sirius_tpu_torch.kernels import mgga_xc as k7s
from sirius_tpu_torch.kernels import xc_functionals as xf
from sirius_tpu_torch.testing import threads_per_test_worker

torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
PBESOL = ["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"]
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]


def fields(n=3000, seed=11):
    """Spin densities with zero, sub-threshold and threshold channels,
    fully polarized and unpolarized points, and sigma consistent with
    gradients (zero-gradient points included)."""
    rng = np.random.default_rng(seed)
    nu = rng.uniform(0.0, 1.2, n) ** 3
    nd = rng.uniform(0.0, 1.2, n) ** 3
    nu[:40] = 0.0
    nd[20:60] = 0.0
    nu[100:140] = 1e-14
    nd[130:170] = 5e-14
    nu[200:240] = nd[200:240]
    nd[300:310] = 1e-13
    gu = rng.standard_normal((3, n)) * 0.3 * np.cbrt(nu)
    gd = rng.standard_normal((3, n)) * 0.3 * np.cbrt(nd)
    gu[:, 400:440] = 0.0
    suu, sud, sdd = ((a * b).sum(0) for a, b in ((gu, gu), (gu, gd), (gd, gd)))
    return nu, nd, suu, sud, sdd


def structured_partials(names, nu, nd, suu, sud, sdd):
    """(e, v_up, v_dn, vsigma_uu, vsigma_ud, vsigma_dd) of a PBE-family set
    as the compiled instantiation forms them: exchange per channel over
    (n_s, sigma_ss), correlation over (n_up, n_dn, sigma), the sigma
    partial chained back with the weights (1, 2, 1); dead channels
    sanitized before and masked after, as xc.py:341-379 does."""
    mu = xf.PBE_MU if names == PBE else xf.PBESOL_MU
    corr = xf.GGA_FUNCS[names[1]]
    t = [torch.as_tensor(a) for a in (nu, nd, suu, sud, sdd)]
    up0, dn0 = t[0] < xf.DENS_TH, t[1] < xf.DENS_TH
    nu_s = torch.where(up0, xf.DENS_TH, t[0])
    nd_s = torch.where(dn0, xf.DENS_TH, t[1])
    suu_s = torch.where(up0, 0.0, t[2])
    sud_s = torch.where(up0 | dn0, 0.0, t[3])
    sdd_s = torch.where(dn0, 0.0, t[4])
    with torch.enable_grad():
        def half(ns, ss):
            ns, ss = (x.detach().requires_grad_(True) for x in (ns, ss))
            x = xf._pbe_x_half(2 * ns, 4 * ss, mu)
            return (x.detach(),) + torch.autograd.grad(x.sum(), (ns, ss))

        xu, dxu_n, dxu_s = half(nu_s, suu_s)
        xd, dxd_n, dxd_s = half(nd_s, sdd_s)
        cu, cd, cs = (x.detach().requires_grad_(True)
                      for x in (nu_s, nd_s, suu_s + 2.0 * sud_s + sdd_s))
        zero = torch.zeros_like(cs)
        c = corr(cu, cd, cs, zero, zero)
        dc_u, dc_d, dc_s = torch.autograd.grad(c.sum(), (cu, cd, cs))
    e = 0.5 * (xu + xd) + c.detach()
    out = (0.5 * dxu_n + dc_u, 0.5 * dxd_n + dc_d, 0.5 * dxu_s + dc_s,
           2.0 * dc_s, 0.5 * dxd_s + dc_s)
    masks = (up0, dn0, up0, up0 | dn0, dn0)
    return (e,) + tuple(torch.where(m, 0.0, v) for v, m in zip(out, masks))


@pytest.mark.parametrize("names", [PBE, PBESOL], ids=["pbe", "pbesol"])
def test_compiled_gga_partials_match_jax_grad(names):
    nu, nd, suu, sud, sdd = fields()
    want = jax_xc.XCFunctional(names).evaluate_polarized(
        *map(jnp.asarray, (nu, nd, suu, sud, sdd)))
    got = structured_partials(names, nu, nd, suu, sud, sdd)
    keys = ("e", "v_up", "v_dn", "vsigma_uu", "vsigma_ud", "vsigma_dd")
    for key, g in zip(keys, got):
        w = np.asarray(want[key])
        err = float(np.max(np.abs(g.numpy() - w)))
        assert np.all(np.isfinite(g.numpy())), key
        assert err <= 1e-13 * float(np.max(np.abs(w))), (key, err)


def legal_lists(funcs):
    """Every non-empty list of distinct names drawn from funcs, in order."""
    return [list(c) for r in range(1, len(funcs) + 1)
            for c in itertools.combinations(funcs, r)]


def test_gga_instantiation_maps_lists_to_sets():
    lda_gga = list(xf.LDA_FUNCS) + list(xf.GGA_FUNCS)
    for names in legal_lists(lda_gga):
        kind, number = k7g.instantiation(names)
        want = ("pbe", 1) if sorted(names) == sorted(PBE) else (
            ("pbesol", 2) if sorted(names) == sorted(PBESOL) else ("mask", 0))
        assert (kind, number) == want, names
    # the sets in either order; every GGA deck of the smoke runs a set
    assert k7g.instantiation(PBE[::-1]) == ("pbe", 1)
    decks = [p[2]["xc_functionals"] for p in chip_smoke.XC_DECKS.values()
             if any(n in xf.GGA_FUNCS for n in p[2]["xc_functionals"])]
    assert decks and all(k7g.instantiation(d)[0] != "mask" for d in decks)
    with pytest.raises(ValueError):
        k7g.instantiation(SCAN)


def test_mgga_instantiation_maps_lists_to_sets():
    for names in legal_lists(list(xf.LDA_FUNCS)[:2] + ["XC_GGA_X_PBE"]
                             + list(xf.MGGA_FUNCS)):
        if not any(n in xf.MGGA_FUNCS for n in names):
            with pytest.raises(ValueError):
                k7s.instantiation(names)
            continue
        want = ("scan", 1) if sorted(names) == sorted(SCAN) else ("mask", 0)
        assert k7s.instantiation(names) == want, names
    assert k7s.instantiation(SCAN[::-1]) == ("scan", 1)
    decks = [p[2]["xc_functionals"] for p in chip_smoke.XC_DECKS.values()
             if any(n in xf.MGGA_FUNCS for n in p[2]["xc_functionals"])]
    assert decks and all(k7s.instantiation(d) == ("scan", 1) for d in decks)


def test_wrappers_count_launches_by_instantiation():
    # on the CPU the wrappers take their plain versions and count nothing;
    # every counter exists for chip_smoke.py's launch checks
    for fn, kinds in ((k7g.gga_xc, ("pbe", "pbesol", "mask")),
                      (k7s.mgga_xc, ("scan", "mask"))):
        for kind in kinds:
            assert getattr(fn, "launches_" + kind) == 0
    attrs = {name: attr for name, (_, attr) in chip_smoke.wrappers().items()}
    assert attrs["gga_xc.pbe"] == attrs["gga_xc.pbe.unpolarized"] == \
        "launches_pbe"
    assert attrs["gga_xc.pbesol.unpolarized"] == "launches_pbesol"
    assert attrs["mgga_xc.scan"] == "launches_scan"
    assert attrs["gga_xc.mask"] == attrs["mgga_xc.mask"] == "launches_mask"
    assert "gga_xc.pbesol" in chip_smoke.XC_DECK_PATH["gamma_nc_pbesol"][1]


def test_literal_constants_match_jax():
    src = open(os.path.join(ROOT, "sirius_tpu_torch", "csrc",
                            "xc_sets.cuh")).read()
    lit = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"constexpr double (k\w+) = ([-0-9.e]+);", src)}
    pi = math.pi
    want = {"kRsK": (3.0 / (4.0 * pi)) ** (1.0 / 3.0),
            "kKfK": (3.0 * pi**2) ** (1.0 / 3.0),
            "kFzDen": 2.0 ** (4.0 / 3.0) - 2.0,
            "kFpp0": 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0)),
            "kPbeGamma": float(jax_xc._PBE_GAMMA),
            "kScanTauU": 0.3 * (3.0 * pi**2) ** (2.0 / 3.0),
            "kScanT2K": (3.0 * pi**2 / 16.0) ** (2.0 / 3.0),
            "kScanB1": float(jax_xc._SCAN_B1),
            "kScanB2": float(jax_xc._SCAN_B2),
            "kScanB4": float(jax_xc._SCAN_B4)}
    for name, value in want.items():
        assert lit[name] == pytest.approx(value, rel=4e-16, abs=0), name
