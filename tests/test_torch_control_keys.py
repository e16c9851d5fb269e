"""The control keys of the port and its refusal strings: no key is accepted
and then ignored where the JAX package acts on it. print_forces and
print_stress return forces and stress (tests/test_torch_forces.py,
tests/test_torch_stress.py hold their values); autosave_every > 0 raises,
naming the ROADMAP item that brings the checkpoint; stress under mGGA
raises, as in the JAX package, while the forces run; a non-collinear run
returns neither, as the JAX package's run_scf_nc does; every refusal names
the queue 1 item that brings what it refuses, and the refusals of items
that have landed (the mixers, UPF species, spin-orbit) run now."""

import numpy as np
import pytest
import torch

from sirius_tpu_torch.config.schema import MixerConfig
from sirius_tpu_torch.crystal.atom_type import AtomType
from sirius_tpu_torch.dft.mixer import Mixer
from sirius_tpu_torch.dft.scf import run_scf
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      synthetic_silicon_species,
                                      threads_per_test_worker, write_upf)

torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(1, 1, 1), num_bands=8,
             ultrasoft=False, use_symmetry=False,
             positions=np.array([[0.0, 0, 0], [0.21, 0.27, 0.23]]))
SCAN = ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]


def context(**extra):
    return synthetic_silicon_context(
        extra_params={"num_dft_iter": 2, "density_tol": 0.0,
                      "energy_tol": 0.0, **extra}, **SMALL)


def test_autosave_raises_naming_queue_1_item_6():
    ctx = context()
    ctx.cfg.control.autosave_every = 1
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")
    ctx.cfg.control.autosave_every = 0
    assert run_scf(ctx.cfg, ctx=ctx, device="cpu")["num_scf_iterations"] == 2


def test_stress_under_mgga_raises_and_forces_run():
    ctx = context(xc_functionals=SCAN)
    ctx.cfg.control.print_stress = True
    with pytest.raises(NotImplementedError,
                       match="stress with mGGA is not implemented"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")
    # the forces run under mGGA, with no tau term, as in the JAX package
    ctx.cfg.control.print_stress = False
    ctx.cfg.control.print_forces = True
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    f = np.asarray(res["forces"])
    assert f.shape == (2, 3) and np.all(np.isfinite(f))
    assert "stress" not in res


def test_noncollinear_returns_neither_forces_nor_stress():
    # the JAX package's run_scf hands a non-collinear deck to run_scf_nc,
    # which never reads the two keys (sirius_tpu/dft/scf.py:244-259): the
    # port keeps that result (ROADMAP queue 3, the keys both packages
    # ignore)
    ctx = synthetic_silicon_context(
        extra_params={"num_dft_iter": 1, "density_tol": 0.0,
                      "energy_tol": 0.0, "num_mag_dims": 3},
        **dict(SMALL, num_bands=16))
    ctx.cfg.control.print_forces = True
    ctx.cfg.control.print_stress = True
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == 1
    assert "forces" not in res and "stress" not in res


def test_no_forces_without_an_iteration():
    # the JAX package computes them only when an iteration ran
    ctx = context(num_dft_iter=0)
    ctx.cfg.control.print_forces = True
    ctx.cfg.control.print_stress = True
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert "forces" not in res and "stress" not in res


def _refusal(case, tmp_path):
    ctx = context()
    p = ctx.cfg.parameters
    if case == "fp-lapw":
        p.electronic_structure_method = "full_potential_lapwlo"
    elif case == "mixer":
        ctx.cfg.mixer.type = "broyden2"
    elif case == "hubbard":
        p.hubbard_correction = True
    elif case == "spin-orbit":
        p.so_correction = True
    elif case == "paw":
        ctx.unit_cell.atom_types[0].pseudo_type = "PAW"
    elif case == "upf":
        path = write_upf(synthetic_silicon_species(ultrasoft=False),
                         str(tmp_path / "Si.pbe.UPF"))
        return lambda: AtomType.from_file("Si", path)
    elif case == "mixer-class":
        return lambda: Mixer(MixerConfig(type="anderson_stable"),
                             ctx.gvec.glen2, omega=1.0, device="cpu")
    return lambda: run_scf(ctx.cfg, ctx=ctx, device="cpu")


# refusals of earlier slices whose item has landed: the call runs now (a
# collinear deck ignores so_correction, as the JAX package's does: ROADMAP
# queue 3 item 15)
PORTED = ("mixer", "mixer-class", "spin-orbit", "upf")


@pytest.mark.parametrize("case,item", [
    ("fp-lapw", "item 11"), ("mixer", "item 4"), ("mixer-class", "item 4"),
    ("hubbard", "item 8"), ("spin-orbit", "item 3"), ("paw", "item 8"),
    ("upf", "item 3"),
])
def test_refusals_name_queue_1_items(case, item, tmp_path):
    if case in PORTED:
        out = _refusal(case, tmp_path)()
        if isinstance(out, dict):
            assert out["num_scf_iterations"] == 2
            assert np.isfinite(out["energy"]["total"])
        return
    with pytest.raises(NotImplementedError) as err:
        _refusal(case, tmp_path)()
    msg = str(err.value)
    assert "ROADMAP queue 1, " + item in msg
    assert "slice" not in msg
