"""Port parity: the effective potential (dft/potential.py with K7 / K7b /
K7g / K7s, K10a / K10b and K6 on their plain versions) against the JAX
package's generate_potential on the small antiferromagnetic deck
(ultrasoft, its 8-op magnetic space group, 4 ops spin-flip): unpolarized
PBE, polarized X + PW92, polarized PBE and polarized PBEsol, and SCAN
unpolarized and polarized with a kinetic-energy density tau_g, from the
free-atom density and the deck's initial magnetization plus a seeded
perturbation. Compared: veff_g, bz_g, vxc_g, vha_g, both veff_r_coarse
channels, vtau_r_coarse (SCAN) and every energy, vtau_tau included.
Bound: 1e-12 relative to each field's largest magnitude, energies 1e-12
Ha. Also the gradient and divergence halves (K10a / K10b plain versions)
against the JAX package's _gradient_r and _divergence_g."""

import numpy as np
import pytest
import torch

from sirius_tpu.dft import potential as jax_potential
from sirius_tpu.dft.density import initial_density_g as jax_initial_density
from sirius_tpu.dft.density import initial_magnetization_g as jax_initial_mag
from sirius_tpu.dft.density import symmetrize_pw as jax_symmetrize_pw
from sirius_tpu.dft.xc import XCFunctional as JaxXC
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch.dft.density import grid_tables
from sirius_tpu_torch.dft.potential import (divergence_g, generate_potential,
                                            gradient_r)
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.kernels import xc_gradient as k10
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

AFM = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
           ultrasoft=True, use_symmetry=True,
           moments=np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]]),
           extra_params={"num_mag_dims": 1})
PBE = ["XC_GGA_X_PBE", "XC_GGA_C_PBE"]
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]
CASES = {
    "pbe_unpolarized": (PBE, False),
    "pw92_polarized": (["XC_LDA_X", "XC_LDA_C_PW"], True),
    "pbe_polarized": (PBE, True),
    "pbesol_polarized": (["XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL"], True),
    "scan_unpolarized": (SCAN, False),
    "scan_polarized": (SCAN, True),
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def deck():
    jctx = jax_context(**AFM)
    pctx = port_context(**AFM)
    assert jctx.symmetry.num_ops == 8
    assert sum(op.spin_sign < 0 for op in jctx.symmetry.ops) == 4
    rng = np.random.default_rng(31)
    ng = jctx.gvec.num_gvec
    rho = jax_initial_density(jctx)
    # a perturbed, space-group-symmetric magnetization
    mag = jax_initial_mag(jctx) + jax_symmetrize_pw(
        jctx, 1e-3 * (rng.standard_normal(ng) + 1j * rng.standard_normal(ng))
        / (1.0 + jctx.gvec.glen2), axial_z=True)
    return jctx, pctx, grid_tables(pctx, "cpu"), rho, mag


def kinetic_density(jctx, rho, mag, polarized):
    """A positive, space-group-symmetric tau_g [ns, ng]: per spin the
    uniform-gas value 0.3 (6 pi^2)^(2/3) n_s^(5/3) times a smooth factor
    between 0.5 and 1.5 (unpolarized: one row, the total of both spins)."""
    phase = np.random.default_rng(41).uniform(0.0, 2.0 * np.pi)
    halves = ([0.5 * (rho + mag), 0.5 * (rho - mag)] if polarized
              else [0.5 * rho])
    out = []
    for f_g in halves:
        n_s = np.maximum(jax_potential._to_r(jctx, f_g), 0.0)
        fac = 1.0 + 0.5 * np.sin(phase + np.linspace(0.0, 2.0 * np.pi,
                                                     n_s.size))
        t_r = (0.3 * (6.0 * np.pi**2) ** (2.0 / 3.0) * n_s ** (5.0 / 3.0)
               * fac.reshape(n_s.shape))
        out.append(jax_potential._to_g(jctx, t_r))
    if not polarized:
        out = [2.0 * out[0]]
    return np.stack([jax_symmetrize_pw(jctx, t) for t in out])


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_potential_matches_jax(deck, case):
    jctx, pctx, tables, rho, mag = deck
    names, polarized = CASES[case]
    mgga = names == SCAN
    tau = kinetic_density(jctx, rho, mag, polarized) if mgga else None
    want = jax_potential.generate_potential(jctx, rho, JaxXC(names),
                                            mag if polarized else None,
                                            tau_g=tau)
    got = generate_potential(pctx, torch.as_tensor(rho), XCFunctional(names),
                             tables,
                             torch.as_tensor(mag) if polarized else None,
                             None if tau is None else torch.as_tensor(tau))
    keys = ("veff_g", "vxc_g", "vha_g", "veff_r_coarse") + (
        ("vtau_r_coarse",) if mgga else ())
    assert (got.vtau_r_coarse is None) == (want.vtau_r_coarse is None)
    if mgga:
        assert got.vtau_r_coarse.shape[0] == (2 if polarized else 1)
        assert abs(got.energies["vtau_tau"]) > 1e-3
    for key in keys:
        a, b = getattr(got, key).numpy(), np.asarray(getattr(want, key))
        assert a.shape == b.shape, key
        assert rel(a, b) <= 1e-12, (key, rel(a, b))
    if polarized:
        assert got.veff_r_coarse.shape[0] == 2
        assert rel(got.bz_g.numpy(), want.bz_g) <= 1e-12
        assert abs(got.energies["bxc"]) > 1e-6
    else:
        assert got.bz_g is None and want.bz_g is None
    assert set(got.energies) == set(want.energies)
    for key, value in want.energies.items():
        assert abs(got.energies[key] - value) <= 1e-12, key


def test_mgga_needs_tau(deck):
    _, pctx, tables, rho, _ = deck
    with pytest.raises(ValueError, match="tau_g"):
        generate_potential(pctx, torch.as_tensor(rho), XCFunctional(SCAN),
                           tables)


def test_gradient_and_divergence_match_jax(deck):
    jctx, _, tables, rho, mag = deck
    fields = np.stack([0.5 * (rho + mag), 0.5 * (rho - mag)])
    got = gradient_r(tables, torch.as_tensor(fields)).numpy()
    for s in range(2):
        want = np.stack(jax_potential._gradient_r(jctx, fields[s]))
        assert rel(got[s], want) <= 1e-12
    vec = np.random.default_rng(5).standard_normal(got.shape)
    got_div = divergence_g(tables, torch.as_tensor(vec)).numpy()
    for s in range(2):
        assert rel(got_div[s], jax_potential._divergence_g(jctx, vec[s])) \
            <= 1e-12


def test_gradient_boxes_zero_fill_and_one_to_one(deck):
    # every box slot off the G set holds exactly zero, and each G lands on
    # its own slot (the fine G set has no padded lanes)
    _, pctx, tables, rho, _ = deck
    n = int(np.prod(tables.dims))
    f = torch.as_tensor(rho)[None]
    box = k10.gradient_boxes(f, tables.gcart, tables.fft_index, n,
                             tables.box_to_g)
    idx = tables.fft_index.long()
    off = torch.ones(n, dtype=torch.bool)
    off[idx] = False
    assert torch.all(box[:, :, off] == 0)
    assert len(torch.unique(idx)) == pctx.gvec.num_gvec
    gz = tables.gcart[:, 2]
    torch.testing.assert_close(box[0, 2, idx],
                               torch.complex(-gz * f[0].imag, gz * f[0].real),
                               rtol=0, atol=0)
    back = k10.divergence_pw(box, tables.gcart, tables.fft_index)
    g2 = (tables.gcart ** 2).sum(1)
    torch.testing.assert_close(back[0], -g2 * f[0], rtol=1e-14, atol=1e-14)


def test_wrappers_check_their_inputs(deck):
    _, _, tables, rho, _ = deck
    f = torch.as_tensor(rho)[None]
    n = int(np.prod(tables.dims))
    with pytest.raises(ValueError, match="gcart"):
        k10.gradient_boxes(f, tables.gcart.T.contiguous(), tables.fft_index, n,
                           tables.box_to_g)
    with pytest.raises(ValueError, match="complex128"):
        k10.divergence_pw(torch.zeros((1, 3, 8)), tables.gcart,
                          tables.fft_index)


@pytest.mark.parametrize("nfield", [1, 3])
def test_gradient_r_matches_jax_for_any_field_count(deck, nfield):
    # gradient_r on one and three fields (the SCAN run's unpolarized density,
    # and more fields than a spin pair) against the JAX package's
    # _gradient_r, field by field
    jctx, _, tables, rho, mag = deck
    fields = np.stack([rho, mag, 0.5 * (rho - mag)])[:nfield]
    got = gradient_r(tables, torch.as_tensor(fields)).numpy()
    assert got.shape == (nfield, 3) + tables.dims
    for s in range(nfield):
        want = np.stack(jax_potential._gradient_r(jctx, fields[s]))
        assert rel(got[s], want) <= 1e-12


SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, num_bands=8)
BOX_TO_G_DECKS = {
    "nc": dict(SMALL, ngridk=(2, 2, 2), ultrasoft=False, use_symmetry=False),
    "us_sym": dict(SMALL, ngridk=(2, 2, 2)),
    "gamma": dict(SMALL, ngridk=(1, 1, 1), ultrasoft=False,
                  use_symmetry=False),
}


@pytest.mark.parametrize("name", sorted(BOX_TO_G_DECKS))
def test_box_to_g_inverts_fft_index(name):
    # the table K10a walks: the G index of each fine-box slot, -1 off the G
    # set, on the 2-atom NC, US and Gamma decks
    ctx = port_context(**BOX_TO_G_DECKS[name])
    tables = grid_tables(ctx, "cpu")
    table, idx = tables.box_to_g, tables.fft_index.long()
    ng = ctx.gvec.num_gvec
    assert table.dtype == torch.int32
    assert table.shape == (int(np.prod(tables.dims)),)
    assert torch.equal(table[idx], torch.arange(ng, dtype=torch.int32))
    off = torch.ones(table.shape[0], dtype=torch.bool)
    off[idx] = False
    assert bool(off.any()) and bool((table[off] == -1).all())


def test_gradient_boxes_refuses_a_wrong_table(deck):
    # box_to_g must be int32 [nbox] on the fields' device
    _, _, tables, rho, _ = deck
    f = torch.as_tensor(rho)[None]
    n = int(np.prod(tables.dims))
    args = (f, tables.gcart, tables.fft_index, n)
    with pytest.raises(ValueError, match="box_to_g"):
        k10.gradient_boxes(*args, tables.box_to_g.long())
    with pytest.raises(ValueError, match="box_to_g"):
        k10.gradient_boxes(*args, tables.box_to_g[:-1])
    with pytest.raises(ValueError, match="more than one device"):
        k10.gradient_boxes(*args, tables.box_to_g.to("meta"))
    box = k10.gradient_boxes(*args, tables.box_to_g)
    assert box.shape == (1, 3, n)
