"""The control keys of the port and its refusal strings: no key is accepted
and then ignored where the JAX package acts on it. print_forces and
print_stress return forces and stress (tests/test_torch_forces.py,
tests/test_torch_stress.py hold their values); autosave_every > 0 writes
the checkpoint the JAX package loads, and straggler_detect on raises,
naming the ROADMAP item that brings the watchdog; stress under mGGA
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


def test_autosave_raises_naming_queue_1_item_6(tmp_path):
    # item 6 has landed: control.autosave_every writes the mid-SCF
    # checkpoint, in the JAX package's schema, which its load_state reads
    # with its own checksum; control.straggler_detect on is the refusal
    # left, naming item 12, which brings the watchdog
    from sirius_tpu.io.checkpoint import load_state as jax_load_state
    from sirius_tpu.testing import synthetic_silicon_context as jax_context

    ctx = context()
    path = str(tmp_path / "auto.h5")
    ctx.cfg.control.autosave_every = 1
    ctx.cfg.control.autosave_path = path
    ctx.cfg.control.autosave_keep = 2
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert res["num_scf_iterations"] == 2
    jctx = jax_context(extra_params={"num_dft_iter": 2, "density_tol": 0.0,
                                     "energy_tol": 0.0}, **SMALL)
    state = jax_load_state(path, jctx)
    scf = state["scf"]
    assert int(scf["iteration"]) == 2 and scf["mix_kind"] == "anderson"
    assert list(scf["etot_history"]) == res["etot_history"]
    assert state["psi"].shape == (1, 1, 8, jctx.gkvec.ngk_max)
    older = jax_load_state(path + ".1", jctx)["scf"]
    assert int(older["iteration"]) == 1
    ctx.cfg.control.autosave_every = 0
    ctx.cfg.control.straggler_detect = True
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")


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


def test_noncollinear_checkpoints_as_the_jax_package(tmp_path):
    # run_scf_nc writes and reads no checkpoint in either package
    # (sirius_tpu/dft/scf.py:244-259): restart_from raises, save_to warns
    # and is ignored, resume and the autosave are ignored (the JAX package
    # says nothing there; the port warns, ROADMAP queue 3 item 18)
    ctx = synthetic_silicon_context(
        extra_params={"num_dft_iter": 1, "density_tol": 0.0,
                      "energy_tol": 0.0, "num_mag_dims": 3},
        **dict(SMALL, num_bands=16))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu", restart_from="x.h5")
    ctx.cfg.control.autosave_every = 1
    ctx.cfg.control.autosave_path = str(tmp_path / "auto.h5")
    with pytest.warns(UserWarning) as caught:
        res = run_scf(ctx.cfg, ctx=ctx, device="cpu",
                      save_to=str(tmp_path / "final.h5"),
                      resume=str(tmp_path / "absent.h5"))
    text = " ".join(str(w.message) for w in caught)
    assert "save_to ignored" in text and "resume" in text
    assert res["num_scf_iterations"] == 1
    assert not list(tmp_path.iterdir())


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
