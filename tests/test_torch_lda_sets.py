"""The LDA instantiations of K7 / K7b (csrc/lda_xc.cu, csrc/lda_sets.cuh),
off the card.

X + PW92 and X + VWN5 run as compiled sets: each exchange half from the
cube root of 2 n_s, rs from one cube root of n, the three correlation
channels from one sqrt(rs) with their slopes in rs (a VWN channel's in
closed form), f(zeta) and f'(zeta) from (1 +- zeta)^(1/3), v_up and v_dn by
the chain rule through (rs, zeta), and unpolarized the ec0 channel alone at
zeta = 0. Polarized X + PZ runs a kernel of its own: f(zeta) from the same
cube roots, 2^(4/3) - 2 a literal, the polarized PZ channel from the
unpolarized channel's quotients, everything else the zeta = 0 kernel's
expressions. Here a torch mirror of that algebra is held against jax.grad
of the JAX package's energies (its dead-channel handling included) to
1e-13 relative to each output's largest magnitude, on fields with dead,
threshold, fully polarized and nearly fully polarized points; the mirrored
polarized X + PZ at n_up = n_dn against the zeta = 0 form bit for bit; the
wrapper's choice of instantiation and its launch counters; and the
constants lda_sets.cuh writes as literals against the JAX package's."""

import inspect
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
from sirius_tpu_torch.kernels import lda_xc as k7
from sirius_tpu_torch.kernels import xc_functionals as xf
from sirius_tpu_torch.testing import threads_per_test_worker

torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "sirius_tpu_torch", "csrc", "lda_sets.cuh")
X_PZ = ["XC_LDA_X", "XC_LDA_C_PZ"]
PW92 = ["XC_LDA_X", "XC_LDA_C_PW"]
VWN = ["XC_LDA_X", "XC_LDA_C_VWN"]
TH = xf.DENS_TH
K_RS = (3.0 / (4.0 * math.pi)) ** (1.0 / 3.0)
FZ_DEN = 2.0 ** (4.0 / 3.0) - 2.0
FPP0 = 8.0 / (9.0 * FZ_DEN)
CX = (3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0)


def fields(n=4000, seed=23, ties=False):
    """Spin densities with exactly zero, sub-threshold and threshold
    channels, fully polarized points, equal channels, and channels of 1e2
    to 1e4 beside channels 1e-15 to 1e-14 of them (1 - |zeta| 9 to 90 ulp
    of 1). ties: beside 1 to 8 DENS_TH in place of those, so that zeta
    rounds to +-1 itself or a few ulp from it. There jnp.clip gives zeta's
    slope half (jnp.maximum and jnp.minimum split it at a tie), where the
    port's plain version (torch.clamp) and kernels pass it whole, as they
    do everywhere inside the clip."""
    rng = np.random.default_rng(seed)
    rho = np.exp(rng.uniform(np.log(1e-10), np.log(30.0), n))
    frac = rng.uniform(-1.0, 1.0, n)
    frac[:100] = 1.0
    frac[100:200] = -1.0
    frac[200:300] = 0.0
    nu, nd = 0.5 * rho * (1.0 + frac), 0.5 * rho * (1.0 - frac)
    nu[300:340] = 0.0
    nd[320:360] = 1e-14
    nu[360:400] = TH
    nd[380:420] = np.nextafter(TH, 0.0)
    big = 10.0 ** rng.uniform(2.0, 4.0, 100)
    small = (TH * rng.uniform(1.0, 8.0, 100) if ties
             else big * 10.0 ** rng.uniform(-15.0, -14.0, 100))
    nu[420:520], nd[420:520] = big, small
    nu[520:620], nd[520:620] = small, big
    return nu, nd


def cbrt(t):
    return torch.from_numpy(np.cbrt(t.numpy()))


# ---- the mirror of lda_sets.cuh / lda_xc.cu ----

def x_half(ns):
    """One exchange half: (-cx/2) m^(4/3) at m = 2 n_s and its slope."""
    m = 2.0 * ns
    c = cbrt(m)
    return (-0.5 * CX) * (m * c), (-(4.0 / 3.0) * CX) * c


def pw92_gs(rs, s, a, a1, b1, b2, b3, b4):
    """xc_sets.cuh's pw92_gs on Dual<1> over rs: value and slope, the
    dual's chain rule written out."""
    ds = 0.5 / s
    den = (2.0 * a) * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs)
    dden = (2.0 * a) * (b1 * ds + b2 + b3 * (s + rs * ds) + b4 * 2.0 * rs)
    q = 1.0 / den
    dq = -q / den * dden
    lg = torch.log1p(q)
    dlg = dq / (1.0 + q)
    return (-2.0 * a) * (1.0 + a1 * rs) * lg, (-2.0 * a) * (
        a1 * lg + (1.0 + a1 * rs) * dlg)


PW92_CHANNELS = ((0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294),
                 (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517),
                 (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671))


def header_vwn():
    """{struct: {a, x0, b, c, q, bq2, bx0, bx0q2}} as lda_sets.cuh writes
    them."""
    src = open(HEADER).read()
    out = {}
    for m in re.finditer(r"struct (Vwn\w)\s*\{(.*?)\};", src, re.S):
        out[m.group(1)] = {k: float(v) for k, v in re.findall(
            r"(\w+) = ([-0-9.e]+)", m.group(2))}
    return out


def vwn_gx(rs, x, ix, k):
    """lda_sets.cuh's vwn_gx: F(x) and dF/drs = dF/dx / (2x) with
    dF/dx = (2a / X) (c / x - b x0 / (x - x0))."""
    xx = x * x + k["b"] * x + k["c"]
    ixx = 1.0 / xx
    dx0 = x - k["x0"]
    atn = torch.atan(k["q"] / (2.0 * x + k["b"]))
    f = k["a"] * (torch.log(x * x * ixx) + k["bq2"] * atn
                  - k["bx0"] * (torch.log(dx0 * dx0 * ixx) + k["bx0q2"] * atn))
    df_dx = (2.0 * k["a"]) * ixx * (k["c"] * ix - (k["b"] * k["x0"]) / dx0)
    return f, 0.5 * ix * df_dx


def channels(kind, rs):
    """(ec0, ec1, alpha_c) of a set, each (value, slope in rs)."""
    s = torch.sqrt(rs)
    if kind == "pw92":
        e0, e1, mac = (pw92_gs(rs, s, *c) for c in PW92_CHANNELS)
        return e0, e1, (-mac[0], -mac[1])
    k = header_vwn()
    ix = 1.0 / s
    return tuple(vwn_gx(rs, s, ix, k[name]) for name in ("Vwn0", "Vwn1",
                                                         "VwnA"))


def zeta_f(zeta):
    """f(zeta) and f'(zeta) from (1 +- zeta)^(1/3)."""
    cp, cm = cbrt(1.0 + zeta), cbrt(1.0 - zeta)
    return (((1.0 + zeta) * cp + (1.0 - zeta) * cm - 2.0) * (1.0 / FZ_DEN),
            (4.0 / 3.0) * (cp - cm) * (1.0 / FZ_DEN))


def set_point(kind, nu, nd):
    """lda_set_point: e, v_up, v_dn at sanitized channels."""
    xu, vxu = x_half(nu)
    xd, vxd = x_half(nd)
    n = nu + nd
    zeta = torch.clamp((nu - nd) / n, -1.0, 1.0)
    rs = K_RS / cbrt(n)
    (e0, d0), (e1, d1), (ac, dac) = channels(kind, rs)
    fz, dfz = zeta_f(zeta)
    z2 = zeta * zeta
    z4 = z2 * z2
    dz4 = 4.0 * z2 * zeta
    a, da = ac * (1.0 / FPP0), dac * (1.0 / FPP0)
    d, dd = e1 - e0, d1 - d0
    eps = e0 + a * (fz * (1.0 - z4)) + d * (fz * z4)
    deps_drs = d0 + da * (fz * (1.0 - z4)) + dd * (fz * z4)
    deps_dz = a * (dfz * (1.0 - z4) - fz * dz4) + d * (dfz * z4 + fz * dz4)
    common = eps - rs / 3.0 * deps_drs
    return ((xu + xd) + n * eps, vxu + common + (1.0 - zeta) * deps_dz,
            vxd + common - (1.0 + zeta) * deps_dz)


def set_point_zeta0(kind, nh):
    """lda_set_point_zeta0: e and v = de/drho from the half density."""
    n = nh + nh
    cn = cbrt(n)
    rs = K_RS / cn
    e0, d0 = channels(kind, rs)[0]
    return ((-CX) * (n * cn) + n * e0,
            (-(4.0 / 3.0) * CX) * cn + (e0 - rs / 3.0 * d0))


def pz_eps(rs):
    """lda_xc.cu's pz_eps, the unpolarized channel: eps_c(rs) and its
    slope."""
    g, b1, b2, a, b, c, d = -0.1423, 1.0529, 0.3334, 0.0311, -0.048, 0.002, \
        -0.0116
    srs = torch.sqrt(rs)
    den = 1.0 + b1 * srs + b2 * rs
    lrs = torch.log(rs)
    hi = rs >= 1.0
    return (torch.where(hi, g / den, a * lrs + b + c * rs * lrs + d * rs),
            torch.where(hi, -g * (0.5 * b1 / srs + b2) / (den * den),
                        a / rs + c * (lrs + 1.0) + d))


def pz_eps_pol(rs):
    """lda_xc.cu's pz_eps_pol: the polarized channel from the unpolarized
    channel's quotients 0.5 b1 / sqrt(rs) and a / rs."""
    srs = torch.sqrt(rs)
    iden = 1.0 / (1.0 + 1.3981 * srs + 0.2611 * rs)
    lrs = torch.log(rs)
    hi = rs >= 1.0
    return (torch.where(hi, -0.0843 * iden,
                        0.01555 * lrs - 0.0269 + 0.0007 * rs * lrs
                        - 0.0048 * rs),
            torch.where(hi, 0.0843 * (0.5 * 1.0529 / srs * (1.3981 / 1.0529)
                                      + 0.2611) * (iden * iden),
                        0.0311 / rs * 0.5 + 0.0007 * (lrs + 1.0) - 0.0048))


def x_pz_polarized(nu, nd):
    """lda_xc.cu's x_pz_polarized."""
    cx = 0.75 * (3.0 / math.pi) ** (1.0 / 3.0)
    ex = -cx / 2.0 * ((2.0 * nu) ** (4.0 / 3.0) + (2.0 * nd) ** (4.0 / 3.0))
    vxu = -(4.0 / 3.0) * cx * cbrt(2.0 * nu)
    vxd = -(4.0 / 3.0) * cx * cbrt(2.0 * nd)
    n = nu + nd
    zeta = torch.clamp((nu - nd) / n, -1.0, 1.0)
    rs = cbrt(3.0 / (4.0 * math.pi * n))
    u, du = pz_eps(rs)
    p, dp = pz_eps_pol(rs)
    fz, dfz = zeta_f(zeta)
    eps = u + fz * (p - u)
    deps_drs = du + fz * (dp - du)
    deps_dz = dfz * (p - u)
    common = eps - rs / 3.0 * deps_drs
    return (ex + n * eps, vxu + common + (1.0 - zeta) * deps_dz,
            vxd + common - (1.0 + zeta) * deps_dz)


def x_pz_zeta0(nh):
    """lda_xc.cu's x_pz_zeta0."""
    cx = 0.75 * (3.0 / math.pi) ** (1.0 / 3.0)
    px = (2.0 * nh) ** (4.0 / 3.0)
    ex = -cx / 2.0 * (px + px)
    vx = -(4.0 / 3.0) * cx * cbrt(2.0 * nh)
    n = nh + nh
    rs = cbrt(3.0 / (4.0 * math.pi * n))
    u, du = pz_eps(rs)
    return ex + n * u, vx + (u - rs / 3.0 * du)


def polarized(point, nu, nd):
    """A kernel body's polarized form: sanitize, evaluate, mask."""
    nu, nd = torch.as_tensor(nu), torch.as_tensor(nd)
    up0, dn0 = nu < TH, nd < TH
    e, vu, vd = point(torch.where(up0, TH, nu), torch.where(dn0, TH, nd))
    return e, torch.where(up0, 0.0, vu), torch.where(dn0, 0.0, vd)


def unpolarized(point, rho):
    nh = 0.5 * torch.as_tensor(rho)
    dead = nh < TH
    e, v = point(torch.where(dead, TH, nh))
    return e, torch.where(dead, 0.0, v)


MIRRORS = {
    "pz": (x_pz_polarized, lambda nh: x_pz_zeta0(nh)),
    "pw92": (lambda u, d: set_point("pw92", u, d),
             lambda nh: set_point_zeta0("pw92", nh)),
    "vwn": (lambda u, d: set_point("vwn", u, d),
            lambda nh: set_point_zeta0("vwn", nh)),
}
SETS = {"pz": X_PZ, "pw92": PW92, "vwn": VWN}


def assert_close(got, want, keys):
    for key, g, w in zip(keys, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.all(np.isfinite(g)), key
        err = float(np.max(np.abs(g - w)))
        assert err <= 1e-13 * float(np.max(np.abs(w))), (key, err)


@pytest.mark.parametrize("kind", sorted(MIRRORS))
def test_mirrored_sets_match_jax_grad(kind):
    nu, nd = fields()
    fn = jax_xc.XCFunctional(SETS[kind])
    pol, zeta0 = MIRRORS[kind]
    want = fn.evaluate_polarized(jnp.asarray(nu), jnp.asarray(nd))
    assert_close(polarized(pol, nu, nd),
                 (want["e"], want["v_up"], want["v_dn"]),
                 ("e", "v_up", "v_dn"))
    rho = nu + nd
    want = fn.evaluate(jnp.asarray(rho))
    assert_close(unpolarized(zeta0, rho), (want["e"], want["v"]), ("e", "v"))


@pytest.mark.parametrize("kind", sorted(MIRRORS))
def test_mirrored_sets_match_the_plain_version_at_zeta_ties(kind):
    # zeta at +-1 itself and a few ulp from it: the mirror against the
    # port's plain version, which the kernels are held to on the card
    nu, nd = fields(ties=True)
    n = torch.as_tensor(nu) + torch.as_tensor(nd)
    zeta = (torch.as_tensor(nu) - torch.as_tensor(nd)) / n
    assert bool((zeta.abs() == 1.0).any() and (zeta.abs() < 1.0).any())
    pol, zeta0 = MIRRORS[kind]
    want = k7.lda_xc_plain(torch.as_tensor(nu), torch.as_tensor(nd),
                           SETS[kind])
    assert_close(polarized(pol, nu, nd), want, ("e", "v_up", "v_dn"))


def bits(t):
    return t.contiguous().view(torch.int64)


def test_mirrored_polarized_pz_is_zeta0_bitwise_at_equal_channels():
    nu, _ = fields()
    rho = 2.0 * nu
    half = torch.as_tensor(0.5 * rho)
    e, vu, vd = polarized(x_pz_polarized, half, half)
    e0, v0 = unpolarized(x_pz_zeta0, rho)
    assert torch.equal(bits(e), bits(e0))
    assert torch.equal(bits(vu), bits(v0)) and torch.equal(bits(vd), bits(v0))


def test_sets_at_zeta0_reduce_to_ec0():
    # the polarized set at (rho/2, rho/2) is the unpolarized ec0 form: the
    # alpha_c and (ec1 - ec0) terms add +-0, v_up = v_dn = v
    nu, _ = fields()
    for kind in ("pw92", "vwn"):
        pol, zeta0 = MIRRORS[kind]
        half = torch.as_tensor(nu)
        e, vu, vd = polarized(pol, half, half)
        e0, v0 = unpolarized(zeta0, 2.0 * half)
        assert_close((e, vu, vd), (e0, v0, v0), ("e", "v_up", "v_dn"))


def legal_lists():
    funcs = list(xf.LDA_FUNCS)
    return [list(c) for r in range(1, len(funcs) + 1)
            for c in itertools.combinations(funcs, r)]


def test_lda_instantiation_maps_lists_to_sets():
    want = {tuple(sorted(X_PZ)): ("pz", 1), tuple(sorted(PW92)): ("pw92", 2),
            tuple(sorted(VWN)): ("vwn", 3)}
    for names in legal_lists():
        for order in (names, names[::-1]):
            assert k7.instantiation(order) == want.get(
                tuple(sorted(names)), ("mask", 0)), order
    # every LDA deck of the smoke runs a compiled set
    decks = [p[2]["xc_functionals"] for p in chip_smoke.XC_DECKS.values()
             if all(n in xf.LDA_FUNCS for n in p[2]["xc_functionals"])]
    assert decks and all(k7.instantiation(d)[0] != "mask" for d in decks)
    # the smoke's mask checks run a list no set covers
    for name in ("lda_xc.mask", "lda_xc.mask.unpolarized"):
        assert k7.instantiation(chip_smoke.XC_CHECKS[name][0]) == ("mask", 0)
    for bad in (["XC_GGA_X_PBE"], [], ["XC_LDA_X", "XC_LDA_X"]):
        with pytest.raises(ValueError):
            k7.instantiation(bad)


class FakeLibrary:
    """Records the C entry's arguments in place of a launch."""

    def __init__(self):
        self.calls = []

    def lda_xc(self, *args):
        self.calls.append(args)
        return 0


COUNTERS = ("launches", "launches_pz_unpolarized", "launches_pz_polarized",
            "launches_pw92", "launches_vwn", "launches_mask")


def test_launches_count_by_instantiation(monkeypatch):
    # the launch path on CPU tensors with the library and stream mocked:
    # each call passes its set's number and mask and counts on the total
    # and on its instantiation's counter
    lib = FakeLibrary()
    monkeypatch.setattr(k7.build, "library", lambda name: lib)
    monkeypatch.setattr(k7.build, "stream_of", lambda t: None)
    for attr in COUNTERS:
        monkeypatch.setattr(k7.lda_xc, attr, 0)
    t = torch.ones(5, dtype=torch.float64)
    cases = ((X_PZ, True, "launches_pz_unpolarized", 1),
             (X_PZ, False, "launches_pz_polarized", 1),
             (PW92, False, "launches_pw92", 2),
             (PW92, True, "launches_pw92", 2),
             (VWN[::-1], True, "launches_vwn", 3),
             (["XC_LDA_X"], False, "launches_mask", 0),
             (["XC_LDA_C_PZ"], True, "launches_mask", 0))
    for i, (names, unpol, counter, number) in enumerate(cases):
        before = {a: getattr(k7.lda_xc, a) for a in COUNTERS}
        e, v, vd = k7._launch(t, None if unpol else t, unpol, names)
        assert (vd is None) == unpol
        after = {a: getattr(k7.lda_xc, a) for a in COUNTERS}
        moved = {a for a in COUNTERS if after[a] != before[a]}
        assert moved == {"launches", counter}, (names, unpol, moved)
        args = lib.calls[i]
        assert args[5:9] == (5, int(unpol), xf.func_mask(names), number)
    # chip_smoke.py reads each instantiation's counter
    attrs = {name: attr for name, (_, attr) in chip_smoke.wrappers().items()}
    assert attrs[chip_smoke.PZ0] == "launches_pz_unpolarized"
    assert attrs["lda_xc.pz"] == "launches_pz_polarized"
    assert attrs["lda_xc.pw92"] == attrs["lda_xc.pw92.unpolarized"] == \
        "launches_pw92"
    assert attrs["lda_xc.vwn.unpolarized"] == "launches_vwn"
    assert attrs["lda_xc.mask"] == "launches_mask"
    assert attrs["lda_xc"] == "launches"


def jax_source_digits(fn, call):
    """The arguments of each `call(rs, ...)` in a JAX function's source,
    numbers where they are constant expressions, else None."""
    def value(arg):
        try:
            return float(eval(arg, {"jnp": np}))
        except NameError:
            return None

    src = inspect.getsource(fn)
    return [[value(a) for a in m.group(1).split(", ")]
            for m in re.finditer(call + r"\(rs, ([^\n]*)\)", src)]


def test_literals_match_jax():
    src = open(HEADER).read()
    kcx = float(re.search(r"constexpr double kCx = ([-0-9.e]+);", src)
                .group(1))
    assert kcx == pytest.approx((3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0),
                                rel=4e-16, abs=0)
    # VWN: the fit digits of xc.py:117-133 and the constants derived from
    # them as _vwn_f derives them
    jax_vwn = jax_source_digits(jax_xc._lda_c_vwn_e, "_vwn_f")
    assert len(jax_vwn) == 3
    hdr = header_vwn()
    for name, (a, x0, b, c) in zip(("Vwn0", "Vwn1", "VwnA"), jax_vwn):
        k = hdr[name]
        q = math.sqrt(4.0 * c - b * b)
        want = {"a": a, "x0": x0, "b": b, "c": c, "q": q, "bq2": 2.0 * b / q,
                "bx0": b * x0 / (x0 * x0 + b * x0 + c),
                "bx0q2": 2.0 * (b + 2.0 * x0) / q}
        assert set(k) == set(want), name
        for key, value in want.items():
            assert k[key] == pytest.approx(value, rel=4e-16, abs=0), (name,
                                                                      key)
    # PW92's published digits (mod=False): the A coefficients of
    # xc.py:84-87 with the fit's other digits
    pw = re.search(r"struct Pw92Set.*?\n\};", src, re.S).group(0)
    got = [[float(v) for v in m.group(1).split(", ")]
           for m in re.finditer(r"pw92_gs\(rs, s, ([-0-9., e]+)\)", pw)]
    jax_pw = jax_source_digits(jax_xc._lda_c_pw_e, "_pw92_g")
    a_pub = (0.031091, 0.015545, 0.016887)
    assert got == [[a] + d[1:] for a, d in zip(a_pub, jax_pw)]
    assert got == [list(c) for c in PW92_CHANNELS]
    pub = inspect.getsource(jax_xc._lda_c_pw_e)
    assert "else (0.031091, 0.015545, 0.016887)" in pub


def test_header_literals_reproduce_jax_channels():
    # the VWN literals through the mirror's channel against the JAX
    # package's own _vwn_f, and PW92's against _pw92_g
    rs = torch.as_tensor(np.exp(np.linspace(np.log(1e-3), np.log(1e3), 400)))
    hdr = header_vwn()
    s = torch.sqrt(rs)
    for name, args in zip(("Vwn0", "Vwn1", "VwnA"),
                          jax_source_digits(jax_xc._lda_c_vwn_e, "_vwn_f")):
        f, _ = vwn_gx(rs, s, 1.0 / s, hdr[name])
        want = np.asarray(jax_xc._vwn_f(jnp.asarray(rs.numpy()), *args))
        np.testing.assert_allclose(f.numpy(), want, rtol=1e-13, atol=0)
    for digits in PW92_CHANNELS:
        g, _ = pw92_gs(rs, s, *digits)
        want = np.asarray(jax_xc._pw92_g(jnp.asarray(rs.numpy()), *digits))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-13, atol=0)
