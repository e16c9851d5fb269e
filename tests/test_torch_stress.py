"""Port parity for the stress tensor (sirius_tpu_torch/dft/stress.py).

(a) Same state: the JAX package's end state on the small force decks
    (tests/test_torch_forces.py::jax_end_state: norm-conserving, ultrasoft
    and polarized PBE) through convert.forces_state_from_numpy into
    StressCalculator.compute on the CPU: every term and the total within
    1e-10 Ha/bohr^3 of the JAX package's.
(b) The port alone against finite differences of its free energy under
    lattice strain, as tests/test_stress.py holds the JAX package
    (norm-conserving and ultrasoft, 4e-6 Ha/bohr^3; its Hubbard case
    fails in the reference and is left out with Hubbard itself).
(d) The host rho_aug_g copy, the plain version of the strained
    augmentation charge, against the JAX package's on strained Q(G)
    tables, to 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import sirius_tpu_torch.context as port_cm
import sirius_tpu_torch.crystal.unit_cell as port_ucm
from sirius_tpu_torch.convert import forces_state_from_numpy
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.dft.stress import StressCalculator
from sirius_tpu_torch.dft.xc import XCFunctional
from sirius_tpu_torch.testing import synthetic_silicon_context
from sirius_tpu_torch.testing import threads_per_test_worker
from test_torch_forces import SAME_STATE, jax_end_state, port_context

torch.set_num_threads(threads_per_test_worker())

STRESS_TERMS = ("kin", "har", "vloc", "ewald", "xc", "nonloc", "total")


@pytest.mark.parametrize("name", sorted(SAME_STATE))
def test_stress_terms_match_jax_on_the_same_state(name):
    cap = jax_end_state(name)
    ctx = port_context(name)
    st = forces_state_from_numpy(cap, "cpu")
    calc = StressCalculator(
        ctx, XCFunctional(ctx.cfg.parameters.xc_functionals), device="cpu")
    got = calc.compute(st["rho_g"], st["mag_g"], st["psi"], st["occ"],
                       st["evals"], st["d_by_spin"],
                       st["dm_blocks_by_spin"] if ctx.aug is not None
                       else None)
    want = cap["stress_terms"]
    assert sorted(got) == sorted(want) == sorted(STRESS_TERMS)
    for term in STRESS_TERMS:
        assert got[term].shape == (3, 3)
        assert np.max(np.abs(got[term] - np.asarray(want[term]))) <= 1e-10, term
    assert np.max(np.abs(got["total"])) > 1e-4
    assert set(calc.seconds) == {"setup", *STRESS_TERMS} - {"total"}


def _strained_context(ctx, strain):
    """The deck's context rebuilt on the strained lattice."""
    uc = ctx.unit_cell
    lat = uc.lattice @ (np.eye(3) + strain).T
    uc2 = port_ucm.UnitCell(
        lattice=lat, atom_types=uc.atom_types, type_of_atom=uc.type_of_atom,
        positions=uc.positions, moments=uc.moments)
    orig = port_ucm.UnitCell.from_config
    try:
        port_ucm.UnitCell.from_config = staticmethod(lambda c, b=".": uc2)
        return port_cm.SimulationContext.create(ctx.cfg, ".")
    finally:
        port_ucm.UnitCell.from_config = orig


def _fd_run(ultrasoft, strain=None):
    # gk inside a G-shell gap for the ultrasoft case (tests/test_stress.py
    # says why: a shell at 3.000117 would enter the basis under the strain)
    ctx = synthetic_silicon_context(
        gk_cutoff=3.09 if ultrasoft else 3.5,
        pw_cutoff=7.0 if ultrasoft else 8.0, ngridk=(1, 1, 1), num_bands=8,
        ultrasoft=ultrasoft, use_symmetry=False,
        positions=np.array([[0.0, 0, 0], [0.26, 0.24, 0.25]]),
        extra_params={"density_tol": 5e-9, "energy_tol": 1e-11,
                      "num_dft_iter": 60})
    if strain is not None:
        ctx = _strained_context(ctx, strain)
    ctx.cfg.control.print_stress = strain is None
    return run_scf(ctx.cfg, ctx=ctx, device="cpu"), ctx.unit_cell.omega


@pytest.mark.parametrize("ultrasoft", [False, True])
def test_stress_matches_finite_difference(ultrasoft):
    res, omega0 = _fd_run(ultrasoft)
    assert res["converged"]
    sigma = np.asarray(res["stress"])
    assert sigma.shape == (3, 3)
    assert res["stress_seconds"] > 0
    h = 1e-4
    for (a, b) in [(0, 0), (0, 1)]:
        eps = np.zeros((3, 3))
        eps[a, b] += h
        eps[b, a] += h
        fp = _fd_run(ultrasoft, eps)[0]["energy"]["free"]
        fm = _fd_run(ultrasoft, -eps)[0]["energy"]["free"]
        fd = (fp - fm) / (2 * h) / 2.0 / omega0
        np.testing.assert_allclose(sigma[a, b], fd, atol=4e-6,
                                   err_msg=f"{(a, b)}")


@pytest.mark.parametrize("eps_xy", [0.0, 1e-5, -3e-3])
def test_strained_rho_aug_matches_jax(eps_xy):
    from sirius_tpu.ops.augmentation import rho_aug_g as jax_rho_aug_g
    from sirius_tpu.testing import synthetic_silicon_context as jax_context

    from sirius_tpu_torch.ops.augmentation import rho_aug_g

    kw = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8,
              ultrasoft=True, use_symmetry=False,
              positions=np.array([[0.0, 0, 0], [0.21, 0.27, 0.23]]))
    ctx, jctx = synthetic_silicon_context(**kw), jax_context(**kw)
    calc = StressCalculator(ctx, XCFunctional(["XC_LDA_X"]), device="cpu")
    eps = np.zeros((3, 3))
    eps[0, 1] = eps[1, 0] = eps_xy
    q = calc.strained_q(eps)
    rng = np.random.default_rng(7)
    nbf = ctx.unit_cell.atom_types[0].num_beta_lm
    dm = []
    for _ in range(ctx.unit_cell.num_atoms):
        a = rng.standard_normal((nbf, nbf)) + 1j * rng.standard_normal((nbf, nbf))
        dm.append(a + a.conj().T)
    got = rho_aug_g(ctx.unit_cell, ctx.gvec, ctx.aug, dm, q)
    want = jax_rho_aug_g(jctx.unit_cell, jctx.gvec, jctx.aug, dm,
                         q_pw_by_type=q)
    scale = np.max(np.abs(want))
    assert scale > 1e-6
    assert np.max(np.abs(got - want)) <= 1e-12 * scale
