"""Port parity: the potential's pointwise passes, K17a-K17d (kernels/
xc_inputs.py, xc_outputs.py, hartree_veff.py, coarse_potential.py; off the
card their plain versions).

(a) dft/potential.py::generate_potential against the JAX package's device
form, sirius_tpu/dft/potential.py::generate_potential_device under
jax.jit, with its tables from build_potential_device_tables and the
symmetry tables as sirius_tpu/dft/fused.py builds them: unpolarized
X + PZ, polarized X + PW92, PBE unpolarized and polarized, each with and
without the space group, each once with a smooth, symmetric core charge
(a Gaussian on every atom) set on both contexts before their tables are
built. Bound: 1e-12 relative to each field's largest magnitude (veff_g,
vha_g, vxc_g, bz_g, veff_r_coarse), 1e-12 Ha on every energy.
(b) each pass's plain version against the jnp lines it replaces on the
same numpy inputs: NaN in rho or m comes out NaN in the same places, the
G = 0 slot, both clamps, the coarse fill against f_g[coarse_to_fine]
scattered into a zeroed box.
(c) the wrappers refuse wrong types, shapes and devices, and the coarse
table refuses a map that is not one-to-one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.dft.density import build_sym_pw_tables
from sirius_tpu.dft.density import initial_density_g as jax_initial_density
from sirius_tpu.dft.density import initial_magnetization_g as jax_initial_mag
from sirius_tpu.dft.poisson import hartree_potential_g as jax_hartree
from sirius_tpu.dft.potential import (build_potential_device_tables,
                                      generate_potential_device)
from sirius_tpu.dft.xc import XCFunctional as JaxXC
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.dft.density import grid_tables
from sirius_tpu_torch.dft.potential import energies_host, generate_potential
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels import coarse_potential as k17d
from sirius_tpu_torch.kernels import hartree_veff as k17c
from sirius_tpu_torch.kernels import xc_inputs as k17a
from sirius_tpu_torch.kernels import xc_outputs as k17b
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
             ultrasoft=True)
AFM = dict(moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]),
           extra_params={"num_mag_dims": 1})
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
FUNCTIONALS = {
    "x_pz": (["XC_LDA_X", "XC_LDA_C_PZ"], False),
    "x_pw92_polarized": (["XC_LDA_X", "XC_LDA_C_PW"], True),
    "pbe": (PBE, False),
    "pbe_polarized": (PBE, True),
}
FIELDS = ("veff_g", "vha_g", "vxc_g", "veff_r_coarse")
ENERGIES = ("vha", "vxc", "vloc", "veff", "exc", "bxc")
WRAPPERS = (k17a.xc_inputs, k17b.xc_outputs, k17c.hartree_veff,
            k17c.gga_inputs, k17d.coarse_fill, k17d.coarse_stack)
C128 = torch.complex128
F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def core_charge(ctx, amplitude=2.0, alpha=2.0):
    """A Gaussian core charge on every atom, in G: smooth, and symmetric
    under the space group (every atom carries the same one)."""
    g = np.asarray(ctx.gvec.gcart)
    pos = ctx.unit_cell.positions_cart()
    sf = np.exp(-1j * g @ pos.T).sum(axis=1)
    return (amplitude / ctx.unit_cell.omega
            * np.exp(-np.asarray(ctx.gvec.glen2) / (4.0 * alpha)) * sf)


@functools.lru_cache(maxsize=None)
def contexts(polarized: bool, sym: bool):
    spec = dict(SMALL, use_symmetry=sym, **(AFM if polarized else {}))
    jctx, pctx = jax_context(**spec), port_context(**spec)
    rho = jax_initial_density(jctx)
    mag = jax_initial_mag(jctx) if polarized else None
    return jctx, pctx, rho, mag


def jax_potential(jctx, names, rho, mag):
    """generate_potential_device under jax.jit, its tables as the fused
    step builds them."""
    tb = jax.tree_util.tree_map(jnp.asarray,
                                build_potential_device_tables(jctx))
    sym = None
    if (jctx.cfg.parameters.use_symmetry and jctx.symmetry is not None
            and jctx.symmetry.num_ops > 1):
        sym = jax.tree_util.tree_map(jnp.asarray, build_sym_pw_tables(jctx))
    xc = JaxXC(names)
    dims = tuple(jctx.gvec.fft.dims)
    dims_c = tuple(jctx.fft_coarse.dims)
    omega = float(jctx.unit_cell.omega)

    @jax.jit
    def run(r, m, t, s):
        return generate_potential_device(xc, r, m, t, dims, dims_c, omega,
                                         sym_tb=s)

    out = run(jnp.asarray(rho), None if mag is None else jnp.asarray(mag),
              tb, sym)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("core", [False, True], ids=["no_core", "core"])
@pytest.mark.parametrize("sym", [False, True], ids=["nosym", "sym"])
@pytest.mark.parametrize("case", sorted(FUNCTIONALS))
def test_generate_potential_matches_the_device_form(case, sym, core):
    names, polarized = FUNCTIONALS[case]
    jctx, pctx, rho, mag = contexts(polarized, sym)
    if sym:
        assert jctx.symmetry.num_ops > 1
    if core:
        rho_core = core_charge(jctx)
        np.testing.assert_allclose(core_charge(pctx), rho_core, rtol=0,
                                   atol=1e-14)
        jctx = dataclasses.replace(jctx, rho_core_g=rho_core)
        pctx = dataclasses.replace(pctx, rho_core_g=rho_core)
    want = jax_potential(jctx, names, rho, mag)
    tables = grid_tables(pctx, "cpu")
    assert (tables.rho_core_g is None) == (not core)
    assert (tables.sym is None) == (not sym)
    got = generate_potential(pctx, torch.as_tensor(rho), XCFunctional(names),
                             tables,
                             None if mag is None else torch.as_tensor(mag))
    for key in FIELDS + (("bz_g",) if polarized else ()):
        a, b = getattr(got, key).numpy(), want[key]
        assert a.shape == b.shape, key
        assert rel(a, b) <= 1e-12, (key, rel(a, b))
    if not polarized:
        assert got.bz_g is None and want["bz_g"] is None
    e = energies_host(got)
    for name in ENERGIES:
        assert abs(e[name] - float(want["energies"][name])) <= 1e-12, name
    assert abs(e["exc"]) > 0.1
    # off the card every pass takes its plain version and counts nothing
    assert all(w.launches == 0 for w in WRAPPERS)


def test_core_charge_reaches_the_xc_inputs():
    # with a core charge the exc integrand's density is rho + rho_core, and
    # GGA's gradient rows carry it (gga_inputs' plain version)
    jctx, pctx, rho, _ = contexts(False, True)
    pctx = dataclasses.replace(pctx, rho_core_g=core_charge(jctx))
    tables = grid_tables(pctx, "cpu")
    got = generate_potential(pctx, torch.as_tensor(rho), XCFunctional(PBE),
                             tables)
    rho_exc, _ = got.integrands["exc"][0]
    rho_r, _ = got.integrands["vha"][0]
    torch.testing.assert_close(rho_exc, rho_r + tables.rho_core_r, rtol=0,
                               atol=0)
    assert float((rho_exc - rho_r).abs().max()) > 1e-3
    rows = k17c.gga_inputs(torch.as_tensor(rho), tables.rho_core_g, None)
    torch.testing.assert_close(rows[0], torch.as_tensor(rho)
                               + tables.rho_core_g, rtol=0, atol=0)


def test_nan_density_reaches_the_coarse_potential():
    # the supervisor's NaN rung reads a non-finite potential: a NaN in rho
    # must not be clamped away on its way to veff_r_coarse
    jctx, pctx, rho, mag = contexts(True, False)
    tables = grid_tables(pctx, "cpu")
    rho = rho.copy()
    rho[3] = np.nan
    got = generate_potential(pctx, torch.as_tensor(rho),
                             XCFunctional(["XC_LDA_X", "XC_LDA_C_PW"]),
                             tables, torch.as_tensor(mag))
    assert not bool(torch.isfinite(got.veff_r_coarse).any())
    assert not bool(torch.isfinite(got.veff_g).all())


# -- (b) each plain version against the jnp lines it replaces -------------


def boxes(rng, shape=(5, 6, 7)):
    rho = rng.uniform(-0.1, 1.0, shape)
    mag = rng.uniform(-1.5, 1.5, shape) * np.abs(rho)
    core = rng.uniform(0.0, 0.05, shape)
    # NaN in rho at one point, in m at another; rho below each clamp
    rho.flat[0] = np.nan
    mag.flat[1] = np.nan
    rho.flat[2], rho.flat[3], rho.flat[4] = -0.3, 1e-22, 0.0
    core.flat[2:5] = 0.0
    mag.flat[5] = 5.0 * rho.flat[5]  # |m| > rho_xc
    mag.flat[6] = -5.0 * rho.flat[6]
    return rho, mag, core


def cplx(x, rng):
    return torch.as_tensor(x + 1j * rng.standard_normal(x.shape))


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("with_core", [False, True])
def test_xc_inputs_plain_is_the_jnp_lines(polarized, with_core):
    rng = np.random.default_rng(5)
    rho, mag, core = boxes(rng)
    floor = k17a.FLOOR_POLARIZED if polarized else k17a.FLOOR_UNPOLARIZED
    core_np = core if with_core else np.zeros_like(core)
    got = k17a.xc_inputs(cplx(rho, rng),
                         torch.as_tensor(core) if with_core else None,
                         cplx(mag, rng) if polarized else None, floor)
    # sirius_tpu/dft/potential.py:297-304, :332
    rho_xc = jnp.maximum(jnp.asarray(rho) + jnp.asarray(core_np), floor)
    want = {"rho_r": rho, "rho_exc": np.asarray(jnp.asarray(rho) + core_np),
            "rho_xc": np.asarray(rho_xc)}
    if polarized:
        m = jnp.clip(jnp.asarray(mag), -rho_xc, rho_xc)
        want.update(mag_r=mag, n_up=np.asarray(0.5 * (rho_xc + m)),
                    n_dn=np.asarray(0.5 * (rho_xc - m)))
    else:
        assert got.mag_r is None and got.n_up is None
    for key, b in want.items():
        a = getattr(got, key).numpy()
        assert a.flags["C_CONTIGUOUS"], key
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0, err_msg=key)
    assert np.isnan(got.rho_xc.numpy().flat[0])
    # the clamps: 0 unpolarized, 1e-20 polarized
    assert got.rho_xc.numpy().flat[2] == floor
    assert got.rho_xc.numpy().flat[3] == (1e-20 if polarized else 1e-22)
    if polarized:
        for key in ("n_up", "n_dn"):
            assert np.isnan(getattr(got, key).numpy().flat[:2]).all(), key
        # |m| clipped to rho_xc: one channel empty
        assert got.n_dn.numpy().flat[5] == 0.0
        assert got.n_up.numpy().flat[6] == 0.0


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("gga", [False, True])
def test_xc_outputs_plain_is_the_jnp_lines(polarized, gga):
    rng = np.random.default_rng(7)
    shape = (5, 6, 7)
    rho_xc = rng.uniform(0.0, 1.0, shape)
    rho_xc.flat[0], rho_xc.flat[1], rho_xc.flat[2] = np.nan, 0.0, 1e-30
    e = rng.standard_normal(shape)
    v = rng.standard_normal((2,) + shape)
    div = rng.standard_normal((2,) + shape) + 1j * rng.standard_normal(
        (2,) + shape)
    ns = 2 if polarized else 1
    got = k17b.xc_outputs(
        torch.as_tensor(e).reshape(-1), torch.as_tensor(v[0]).reshape(-1),
        torch.as_tensor(rho_xc), torch.as_tensor(v[1]) if polarized else None,
        torch.as_tensor(div[:ns]) if gga else None)
    exc_r, vxc_r, vxc_box, bz_box = got
    # sirius_tpu/dft/potential.py:318-331, :336-346
    vv = [jnp.asarray(v[s]) - (jnp.real(jnp.asarray(div[s])) if gga else 0.0)
          for s in range(ns)]
    want_vxc = 0.5 * (vv[0] + vv[1]) if polarized else vv[0]
    want_exc = jnp.asarray(e) / jnp.maximum(jnp.asarray(rho_xc), 1e-25)
    np.testing.assert_array_equal(np.isnan(exc_r.numpy()),
                                  np.isnan(np.asarray(want_exc)))
    np.testing.assert_allclose(exc_r.numpy(), want_exc, rtol=1e-15, atol=0)
    np.testing.assert_allclose(vxc_r.numpy(), want_vxc, rtol=1e-15,
                               atol=1e-15)
    assert vxc_box.dtype == C128 and not bool(vxc_box.imag.any())
    torch.testing.assert_close(vxc_box.real, vxc_r, rtol=0, atol=0)
    if polarized:
        np.testing.assert_allclose(bz_box.real.numpy(),
                                   0.5 * (vv[0] - vv[1]), rtol=1e-15,
                                   atol=1e-15)
        assert not bool(bz_box.imag.any())
    else:
        assert bz_box is None


def test_hartree_veff_plain_is_the_jnp_lines():
    rng = np.random.default_rng(11)
    ng = 97
    glen2 = rng.uniform(0.0, 5.0, ng)
    glen2[0], glen2[1], glen2[2], glen2[3] = 0.0, 1e-12, 0.9e-12, 1.1e-12
    rho = rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
    rho[4] = np.nan
    vloc = rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
    vxc = rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
    vha, veff = k17c.hartree_veff(*(torch.as_tensor(x) for x in
                                    (rho, glen2, vloc, vxc)))
    want = np.asarray(jax_hartree(jnp.asarray(rho), jnp.asarray(glen2)))
    np.testing.assert_allclose(vha.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(veff.numpy(), vloc + want + vxc, rtol=1e-15,
                               atol=1e-15)
    # the G = 0 slot (and every glen2 <= 1e-12) is +0 + 0i
    for i in range(3):
        z = torch.view_as_real(vha[i:i + 1])
        assert bool((z == 0).all()) and not bool(torch.signbit(z).any())
    assert vha[3] != 0
    assert np.isnan(vha.numpy()[4].real) and np.isnan(veff.numpy()[4].real)


@pytest.mark.parametrize("polarized", [False, True])
def test_gga_inputs_plain_is_the_jnp_lines(polarized):
    rng = np.random.default_rng(13)
    rho, core, mag = (rng.standard_normal(61) + 1j * rng.standard_normal(61)
                      for _ in range(3))
    got = k17c.gga_inputs(torch.as_tensor(rho), torch.as_tensor(core),
                          torch.as_tensor(mag) if polarized else None)
    # sirius_tpu/dft/potential.py:306-307, :334
    r, c, m = jnp.asarray(rho), jnp.asarray(core), jnp.asarray(mag)
    want = ([0.5 * (r + c + m), 0.5 * (r + c - m)] if polarized
            else [r + c])
    assert got.shape == (len(want), 61)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-15,
                               atol=0)
    # neither core nor m: the density itself, nothing to compute
    same = k17c.gga_inputs(torch.as_tensor(rho), None, None)
    assert same.shape == (1, 61) and torch.equal(same[0],
                                                 torch.as_tensor(rho))


@pytest.mark.parametrize("nf", [1, 2, 3])
def test_coarse_fill_is_the_gather_and_zeroed_scatter(nf):
    jctx, pctx, rho, _ = contexts(False, True)
    tables = grid_tables(pctx, "cpu")
    rng = np.random.default_rng(17 + nf)
    ng = pctx.gvec.num_gvec
    fields = [rng.standard_normal(ng) + 1j * rng.standard_normal(ng)
              for _ in range(nf)]
    got = k17d.coarse_fill([torch.as_tensor(f) for f in fields],
                           tables.coarse_box_to_fine)
    nbox = pctx.fft_coarse.num_points
    assert len(got) == nf
    for f, box in zip(fields, got):
        want = np.zeros(nbox, dtype=np.complex128)
        want[pctx.gvec_coarse.fft_index] = f[pctx.coarse_to_fine]
        np.testing.assert_array_equal(box.numpy(), want)
    # the stack of transformed boxes: [V + B, V - B] or [Re f] a field
    tf = [torch.fft.ifftn(b.view(tables.dims_coarse), norm="forward")
          for b in got]
    if nf == 2:
        v, b = (np.asarray(jnp.real(jnp.asarray(t.numpy()))) for t in tf)
        np.testing.assert_array_equal(k17d.coarse_stack(tf, True).numpy(),
                                      np.stack([v + b, v - b]))
    np.testing.assert_array_equal(k17d.coarse_stack(tf, False).numpy(),
                                  np.stack([t.real.numpy() for t in tf]))


# -- (c) what the wrappers refuse -------------------------------------------


def test_coarse_table_refuses_maps_that_are_not_one_to_one():
    idx = np.array([0, 3, 5, 9])
    c2f = np.array([4, 1, 7, 2])
    table = k17d.coarse_box_to_fine(idx, c2f, 10, 8)
    assert table.dtype == np.int32 and table.shape == (10,)
    assert table[3] == 1 and table[1] == -1
    with pytest.raises(ValueError, match="one fine G"):
        k17d.coarse_box_to_fine(idx, np.array([4, 1, 4, 2]), 10, 8)
    with pytest.raises(ValueError, match="one slot"):
        k17d.coarse_box_to_fine(np.array([0, 3, 3, 9]), c2f, 10, 8)
    for bad_idx, bad_c2f in ((idx, np.array([4, 1, 8, 2])),
                             (np.array([0, 3, 5, 10]), c2f),
                             (idx[:3], c2f)):
        with pytest.raises(ValueError, match="must map"):
            k17d.coarse_box_to_fine(bad_idx, bad_c2f, 10, 8)


def test_wrappers_refuse_wrong_types_shapes_and_devices():
    z = torch.zeros(8, dtype=C128)
    g2 = torch.ones(8, dtype=F64)
    box = torch.zeros((2, 2, 2), dtype=C128)
    r = torch.zeros((2, 2, 2), dtype=F64)
    meta_z = torch.zeros(8, dtype=C128, device="meta")
    calls = {
        "hartree_veff dtype": lambda: k17c.hartree_veff(z.to(torch.complex64),
                                                        g2, z, z),
        "hartree_veff shape": lambda: k17c.hartree_veff(z, g2[:7], z, z),
        "hartree_veff glen2": lambda: k17c.hartree_veff(z, z, z, z),
        "hartree_veff device": lambda: k17c.hartree_veff(z, g2, meta_z, z),
        "gga_inputs shape": lambda: k17c.gga_inputs(z, z[:7], None),
        "gga_inputs rank": lambda: k17c.gga_inputs(box, None, box),
        "xc_inputs dtype": lambda: k17a.xc_inputs(r, None, None, 0.0),
        "xc_inputs core": lambda: k17a.xc_inputs(box, box, None, 0.0),
        "xc_inputs mag": lambda: k17a.xc_inputs(box, None, box[0], 0.0),
        "xc_outputs dtype": lambda: k17b.xc_outputs(r.float(), r, r),
        "xc_outputs points": lambda: k17b.xc_outputs(r[0], r, r),
        "xc_outputs div": lambda: k17b.xc_outputs(r, r, r, None, box[None, 0]),
        "xc_outputs div spins": lambda: k17b.xc_outputs(r, r, r, r, box[None]),
        "coarse_fill count": lambda: k17d.coarse_fill(
            [z] * 5, torch.zeros(4, dtype=torch.int32)),
        "coarse_fill table": lambda: k17d.coarse_fill(
            [z], torch.zeros(4, dtype=torch.int64)),
        "coarse_fill fields": lambda: k17d.coarse_fill(
            [z, z[:7]], torch.zeros(4, dtype=torch.int32)),
        "coarse_stack spin": lambda: k17d.coarse_stack([box], True),
        "coarse_stack dtype": lambda: k17d.coarse_stack([r], False),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(name)
    # a device that is neither the CPU nor CUDA
    with pytest.raises(RuntimeError, match="unsupported device"):
        k17c.hartree_veff(meta_z, g2.to("meta"), meta_z, meta_z)
    with pytest.raises(RuntimeError, match="unsupported device"):
        k17d.coarse_stack([box.to("meta")], False)
