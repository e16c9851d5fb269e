"""Port parity: the fused SCF step (dft/fused.py) and the device ops it
runs on the CPU through their plain versions: K13 (kernels/fermi.py), the
device mixer (tests/test_torch_mixer.py) and K15 (kernels/scf_record.py).

- K13's plain version against the JAX package's find_fermi for the four
  smearing kinds on seeded evals: gapped (a gap of a few widths, so the
  count still has a slope at mu), a level degenerate at mu, and a narrow
  width. mu and occ within 1e-12.
- The port's fused run against a live JAX run on one device
  (devices=jax.devices()[:1], control.device_scf "auto": the JAX package's
  FusedScf) on two small 2-atom k-point decks with the space group: the
  ultrasoft LDA deck and its collinear AFM PW92 twin (moments +0.5 / -0.5,
  the shape of pw_us_sym_afm). The port's per-iteration records
  (result["scf_scalars"]) against the `scalars` of the JAX package's
  scf_iteration events: every energy slot and rms within 1e-10 at each of
  the first five iterations, the final energy terms within 1e-8 Ha, the
  iteration count within +-1, S_FINITE 1, S_NEL within 1e-10 of the
  electron count, the four ledger slots below 1e-12 in both packages.
  Both packages' band solves run to a residual of 1e-12: at the default
  loose early tolerance each Davidson stops where its rounding puts it,
  and the records of the first iterations then differ by ~1e-8 between any
  two runs, fused or not. The ultrasoft deck takes 60 Davidson steps, the
  AFM deck 150: at 60 its first band solve leaves 4 of its 64 bands above
  the 1e-12 residual (the worst at 2.3e-12), each package's unconverged
  eigenvectors then differ by rounding, and the density with them, so the
  energy slots of the first five records differ by 4e-10 to 4.4e-9 (the
  band energies, second order in that error, agree to 3e-14); at 150
  steps every band of the first solve converges and the slots agree to
  1.4e-11 (ROADMAP queue 3, item 17). These live runs take 30-70 s a deck
  on one thread and are marked slow.
- The same state: three steps of each package's FusedScf from one carry on
  one band block (K13, the density and the density matrix included): every
  energy slot, rms and eha within 1e-12, the ledger within 1e-14.
- Within the port: control.device_scf "off" runs the host loop (no
  records) within 1e-8 Ha of the fused run; the fused run reads one record
  an iteration (fused.read_record.calls); fuses() picks the decks the JAX
  package builds its FusedScf for (sirius_tpu/dft/scf.py:850-855).
- K15's plain version: the combine of each op (sums in table order, NaN
  through the max, the all-finite flag) on a small table; a NaN in the
  density raises FloatingPointError without supervision and spends the
  rollback ladder with it (ScfAbortError); a carry seeded from fetch_state's
  mixed vector and history steps as the run it came from, bit for bit.
"""

import numpy as np
import pytest
import torch

import sirius_tpu_torch.dft.fused as fused_mod
from sirius_tpu.dft.occupation import find_fermi as jax_find_fermi
from sirius_tpu_torch.dft.fused import (NUM_SCALARS, S_CHG, S_FINITE,
                                        S_HERM, S_NEL, S_ORTHO, S_RMS, S_SYM)
from sirius_tpu_torch.dft.occupation import find_fermi
from sirius_tpu_torch.dft.scf import fuses, run_scf
from sirius_tpu_torch.kernels.scf_record import Segment, scf_record
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      threads_per_test_worker)

torch.set_num_threads(threads_per_test_worker())

KINDS = ("gaussian", "fermi_dirac", "cold", "methfessel_paxton")


def fermi_case(case: str):
    """(evals [nk, ns, nb], kweights, nel, width) from a seed."""
    rng = np.random.default_rng({"gapped": 1, "degenerate": 2,
                                 "narrow": 3}[case])
    nk, ns, nb = 4, 2, 10
    kw = rng.uniform(0.5, 1.5, nk)
    kw /= kw.sum()
    ev = np.sort(rng.uniform(-0.6, 0.4, (nk, ns, nb)), axis=-1)
    width = 0.01
    if case == "gapped":
        # five bands below -0.02, five above +0.02: a gap of four widths
        ev[..., :5] = -0.02 - np.abs(ev[..., :5] + 0.6) * 0.5
        ev[..., 5:] = 0.02 + np.abs(ev[..., 5:]) * 0.5
        nel = 10.0
    elif case == "degenerate":
        # a threefold level at 0.1, half filled
        ev[..., 4:7] = 0.1
        ev[..., :4] -= 0.3
        ev[..., 7:] += 0.5
        nel = 4 * 2 + 1.5 * 2
    else:
        width = 1e-3
        nel = 9.3
    return ev, kw, nel, width


@pytest.mark.parametrize("case", ["gapped", "degenerate", "narrow"])
@pytest.mark.parametrize("kind", KINDS)
def test_find_fermi_matches_jax(kind, case):
    import jax.numpy as jnp

    ev, kw, nel, width = fermi_case(case)
    mu, occ, ent = find_fermi(torch.as_tensor(ev), torch.as_tensor(kw), nel,
                              width, kind=kind, max_occupancy=1.0)
    jmu, jocc, jent = jax_find_fermi(jnp.asarray(ev), jnp.asarray(kw), nel,
                                     width, kind=kind, max_occupancy=1.0)
    assert abs(float(mu) - float(jmu)) <= 1e-12
    assert np.max(np.abs(occ.numpy() - np.asarray(jocc))) <= 1e-12
    assert abs(float(ent) - float(jent)) <= 1e-12
    # the count it was asked for
    got = float(np.sum(kw[:, None, None] * occ.numpy()))
    assert abs(got - nel) <= 1e-9


# two small 2-atom k-point decks with the space group, the band solve run
# tight (see the module docstring); the live runs' Davidson steps
DECKS = {
    "us_sym": {"num_steps": 60},
    "pw_us_sym_afm": dict(
        extra={"xc_functionals": ["XC_LDA_X", "XC_LDA_C_PW"],
               "num_mag_dims": 1},
        moments=[[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]], num_steps=150),
}
SCF = {"num_dft_iter": 30, "density_tol": 1e-9, "energy_tol": 1e-10}
ENERGY_SLOTS = list(range(2, 11))  # vha .. eval_sum
LEDGER = [S_ORTHO, S_CHG, S_SYM, S_HERM]


def deck_context(make, name: str):
    spec = DECKS[name]
    moments = spec.get("moments")
    ctx = make(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
               ultrasoft=True, use_symmetry=True,
               extra_params={**SCF, **spec.get("extra", {})},
               moments=None if moments is None else np.asarray(moments))
    ctx.cfg.iterative_solver.residual_tolerance = 1e-12
    ctx.cfg.iterative_solver.num_steps = 60
    return ctx


@pytest.fixture(scope="module", params=sorted(DECKS))
def runs(request, tmp_path_factory):
    """Each package's fused run on a deck (the JAX package's with its
    scf_iteration records)."""
    import jax

    from sirius_tpu.dft.scf import run_scf as jax_run_scf
    from sirius_tpu.obs import events
    from sirius_tpu.testing import synthetic_silicon_context as jax_context

    name = request.param
    out = {"name": name}
    path = str(tmp_path_factory.mktemp("events") / "events.jsonl")
    jctx = deck_context(jax_context, name)
    jctx.cfg.iterative_solver.num_steps = DECKS[name]["num_steps"]
    events.configure(path)
    try:
        out["jax_auto"] = jax_run_scf(jctx.cfg, ctx=jctx,
                                      devices=jax.devices()[:1])
    finally:
        events.close()
    iters = events.read_events(path, "scf_iteration")
    assert {e["path"] for e in iters} == {"fused"}
    out["jax_records"] = np.array([e["scalars"] for e in iters])
    ctx = deck_context(synthetic_silicon_context, name)
    ctx.cfg.iterative_solver.num_steps = DECKS[name]["num_steps"]
    out["port_auto"] = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    out["nel"] = ctx.unit_cell.num_valence_electrons
    return out


@pytest.fixture(scope="module")
def port_runs():
    """The port's fused run and host loop on the ultrasoft deck at the
    default band solve, and the fused run's record reads."""
    out = {}
    for mode in ("auto", "off"):
        ctx = synthetic_silicon_context(gk_cutoff=3.0, pw_cutoff=7.0,
                                        ngridk=(2, 2, 2), num_bands=8,
                                        extra_params=dict(SCF))
        ctx.cfg.control.device_scf = mode
        reads = fused_mod.read_record.calls
        out[mode] = run_scf(ctx.cfg, ctx=ctx, device="cpu")
        out["reads_" + mode] = fused_mod.read_record.calls - reads
    return out


@pytest.mark.parametrize("name", sorted(DECKS))
def test_fused_step_matches_the_jax_step(name):
    """The same state: three steps of each package's FusedScf from one
    carry (the initial density and potential) on one band block and its
    evals (the port's after two iterations), each step's K13, density and
    density matrix included."""
    import jax.numpy as jnp

    from sirius_tpu.dft.fused import FusedScf as JaxFusedScf
    from sirius_tpu.dft.mixer import Mixer as JaxMixer
    from sirius_tpu.dft.xc import XCFunctional as JaxXC
    from sirius_tpu.parallel.batched import density_kset as jax_density
    from sirius_tpu.parallel.batched import density_matrix_kset as jax_dm
    from sirius_tpu.parallel.batched import make_hkset_params as jax_params
    from sirius_tpu.parallel.batched import split_cplx
    from sirius_tpu.testing import synthetic_silicon_context as jax_context
    from sirius_tpu_torch.dft.density import (build_dm_sym_tables,
                                              grid_tables, initial_density_g,
                                              initial_magnetization_g)
    from sirius_tpu_torch.dft.fused import FusedScf
    from sirius_tpu_torch.dft.mixer import Mixer
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables
    from sirius_tpu_torch.parallel.batched import (density_kset,
                                                   density_matrix_kset,
                                                   make_hkset_params)

    ctx = deck_context(synthetic_silicon_context, name)
    ctx.cfg.parameters.num_dft_iter = 2
    state = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    psi = state["_state"]["psi"]
    ev = torch.as_tensor(np.array(state["band_energies"]))
    p = ctx.cfg.parameters
    polarized = ctx.num_mag_dims == 1
    nel = ctx.unit_cell.num_valence_electrons
    kw = torch.as_tensor(ctx.kweights)
    ns = ctx.num_spins

    # the port's step, set up as run_scf sets it up
    tables = grid_tables(ctx, "cpu")
    x0 = torch.as_tensor(initial_density_g(ctx))
    mag0 = torch.as_tensor(initial_magnetization_g(ctx)) if polarized else None
    xc = XCFunctional(p.xc_functionals)
    pot0 = generate_potential(ctx, x0, xc, tables, mag0)
    if polarized:
        x0 = torch.cat([x0, mag0])
    ps = make_hkset_params(ctx, pot0.veff_r_coarse.numpy(), device="cpu")
    glen2 = ctx.gvec.glen2
    step = FusedScf(
        ctx, xc, Mixer(ctx.cfg.mixer, glen2, ctx.unit_cell.omega,
                       device="cpu", num_components=ns),
        polarized, tables,
        build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                "cpu"),
        build_dm_sym_tables(ctx, "cpu"), ps.beta, ps.ekin, ps.mask)
    step.init_carry(x0, pot0)

    jctx = deck_context(jax_context, name)
    jstep = JaxFusedScf(
        jctx, JaxXC(p.xc_functionals),
        JaxMixer(jctx.cfg.mixer, jctx.gvec.glen2, num_components=ns,
                 omega=jctx.unit_cell.omega),
        polarized, True)
    carry = jstep.init_carry(x0.numpy(), pot0_numpy(pot0))
    jps = jax_params(jctx, pot0.veff_r_coarse.numpy())
    pr, pi = (jnp.asarray(a) for a in split_cplx(psi.numpy()))
    beta = split_cplx(np.asarray(jctx.beta.beta_gk)
                      * np.asarray(jctx.gkvec.mask)[:, None, :])
    jev, jkw = jnp.asarray(ev.numpy()), jnp.asarray(ctx.kweights)
    worst = np.zeros(NUM_SCALARS)
    for _ in range(3):
        mu, occ, ent = find_fermi(ev, kw, nel, p.smearing_width,
                                  kind=p.smearing,
                                  max_occupancy=ctx.max_occupancy)
        occ_w = occ * kw[:, None, None]
        out = step.step(density_kset(ps, psi, occ_w),
                        density_matrix_kset(ps.beta, psi, occ_w), ev, occ_w,
                        ent, psi)
        jmu, jocc, jent = jax_find_fermi(jev, jkw, nel, p.smearing_width,
                                         kind=p.smearing,
                                         max_occupancy=ctx.max_occupancy)
        jocc_w = jocc * jkw[:, None, None]
        dm_re, dm_im = jax_dm(*beta, pr, pi, jocc_w)
        carry, jout = jstep.step(carry, jax_density(jps, pr, pi, jocc_w),
                                 dm_re, dm_im, jev, jocc_w, jent, pr, pi)
        got, want = out.record.numpy(), np.asarray(jout["scalars"])
        worst = np.maximum(worst, np.abs(got - want))
    assert worst[ENERGY_SLOTS + [S_RMS, 1]].max() <= 1e-12, worst
    assert worst[S_FINITE] == 0.0 and worst[LEDGER].max() <= 1e-14, worst


def pot0_numpy(pot):
    """The initial potential's leaves init_carry reads, as numpy."""
    class Pot:
        veff_g = pot.veff_g.numpy()
        bz_g = None if pot.bz_g is None else pot.bz_g.numpy()
    return Pot


@pytest.mark.slow
def test_fused_records_match_the_jax_events(runs):
    want = runs["jax_records"]
    got = np.array(runs["port_auto"]["scf_scalars"])
    assert runs["port_auto"]["device_scf"]
    assert got.shape[1] == want.shape[1] == NUM_SCALARS
    assert abs(len(got) - len(want)) <= 1
    for it in range(5):
        d = np.abs(got[it] - want[it])
        assert d[ENERGY_SLOTS + [S_RMS]].max() <= 1e-10, (it + 1, d)
    etot_gap = np.abs(np.subtract(runs["port_auto"]["etot_history"][:5],
                                  runs["jax_auto"]["etot_history"][:5]))
    assert np.all(etot_gap <= 1e-10), etot_gap
    assert np.all(got[:, S_FINITE] == 1.0)
    assert np.max(np.abs(got[:, S_NEL] - runs["nel"])) <= 1e-10
    for rec in (got, want):
        assert np.max(rec[:, LEDGER]) < 1e-12, rec[:, LEDGER].max(axis=0)


@pytest.mark.slow
def test_fused_run_matches_the_jax_run(runs):
    res, want = runs["port_auto"], runs["jax_auto"]
    assert abs(res["num_scf_iterations"] - want["num_scf_iterations"]) <= 1
    assert res["converged"] and want["converged"]
    for key, value in want["energy"].items():
        assert abs(res["energy"][key] - value) <= 1e-8, key
    if "magnetisation" in want:
        assert abs(res["magnetisation"]["total"][2]
                   - want["magnetisation"]["total"][2]) <= 1e-6


def test_host_loop_matches_the_fused_run(port_runs):
    host, res = port_runs["off"], port_runs["auto"]
    assert res["device_scf"] and not host["device_scf"]
    assert host["scf_scalars"] == []
    assert res["num_scf_iterations"] == host["num_scf_iterations"]
    for key, value in res["energy"].items():
        assert abs(host["energy"][key] - value) <= 1e-8, key


def test_one_record_read_an_iteration(port_runs):
    assert port_runs["reads_auto"] == port_runs["auto"]["num_scf_iterations"]
    assert port_runs["reads_off"] == 0


# decks on which fuses() is held to the JAX package's choice: the deck
# shape, config changes, and whether the JAX package builds its FusedScf
FUSE_DECKS = {
    "kset_anderson": ({}, {}, True),
    "kset_linear": ({}, {"mixer.type": "linear"}, True),
    "kset_broyden1": ({}, {"mixer.type": "broyden1"}, True),
    "kset_anderson_stable": ({}, {"mixer.type": "anderson_stable"}, False),
    "kset_broyden2": ({}, {"mixer.type": "broyden2"}, False),
    "kset_off": ({}, {"control.device_scf": "off"}, False),
    "kset_polarized": ({"extra_params": {"num_mag_dims": 1},
                        "moments": np.array([[0, 0, 0.5], [0, 0, 0.5]])},
                       {}, True),
    "kset_scan": ({"extra_params": {"xc_functionals": [
        "XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]}}, {}, False),
    "gamma": ({"ngridk": (1, 1, 1)}, {}, False),
    "chunked": ({"ngridk": (1, 1, 1)}, {"control.beta_chunked": True}, False),
}


@pytest.mark.parametrize("name", sorted(FUSE_DECKS))
def test_fuses_picks_the_jax_decks(name, monkeypatch):
    import jax

    import sirius_tpu.dft.fused as jax_fused
    from sirius_tpu.dft.scf import run_scf as jax_run_scf
    from sirius_tpu.testing import synthetic_silicon_context as jax_context

    shape, changes, want = FUSE_DECKS[name]
    built = []
    init = jax_fused.FusedScf.__init__

    def spy(self, *args, **kwargs):
        built.append(True)
        init(self, *args, **kwargs)

    monkeypatch.setattr(jax_fused.FusedScf, "__init__", spy)
    kw = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8,
              ultrasoft=True, use_symmetry=True)
    kw.update(shape)
    kw["extra_params"] = {"num_dft_iter": 0, **kw.get("extra_params", {})}
    ctxs = [jax_context(**kw), synthetic_silicon_context(**kw)]
    for c in ctxs:
        for key, value in changes.items():
            section, field = key.split(".")
            setattr(getattr(c.cfg, section), field, value)
    # no iteration runs: the JAX package builds its step before the loop
    jax_run_scf(ctxs[0].cfg, ctx=ctxs[0], devices=jax.devices()[:1])
    assert bool(built) == want
    assert fuses(ctxs[1].cfg, ctxs[1]) == want


def test_record_combines_each_op():
    t = torch.tensor
    f64 = torch.float64
    a = t([1.0, 2.0, 3.0], dtype=f64)
    z = t([1 + 1j, 2 - 1j], dtype=torch.complex128)
    eye = torch.eye(2, dtype=torch.complex128)
    eye[0, 1] = 1e-3j
    segs = [Segment("sum", 0, a), Segment("dot", 0, a, a, scale=2.0),
            Segment("dot_c", 1, z, z),
            Segment("maxabs", 2, a, t([1.0, 2.5, 3.0], dtype=f64)),
            Segment("maxabs_c", 2, z, scale=0.1),
            Segment("eye", 3, eye.contiguous(), param=2),
            Segment("herm", 4, eye.contiguous(), param=2),
            Segment("finite", 5, a),
            Segment("finite", 6, a), Segment("finite", 6,
                                             t([1.0, np.inf], dtype=f64)),
            Segment("maxabs", 7, t([np.nan, 1.0], dtype=f64))]
    rec = scf_record(segs, 9).numpy()
    want = [6.0 + 28.0, 7.0, 0.5, 1e-3, 1e-3, 1.0, 0.0]
    assert np.allclose(rec[:7], want, rtol=1e-15, atol=0.0)
    assert np.isnan(rec[7]) and rec[8] == 0.0


def test_fused_run_refuses_a_non_finite_record(monkeypatch):
    # a NaN in the density reaches the record's S_FINITE. Without
    # supervision the port raises at once; with it (the default) the run
    # rolls back and climbs the ladder, as the JAX package does, and a
    # density poisoned at every iteration spends the ladder (flush, halve
    # beta, leave the fused step; the host loop then meets the NaN too)
    # and aborts with ScfAbortError, a FloatingPointError
    import sirius_tpu_torch.dft.scf as scf_mod
    from sirius_tpu_torch.dft.recovery import ScfAbortError

    real = scf_mod.density_kset

    def poisoned(*args):
        acc = real(*args)
        acc.view(-1)[3] = float("nan")
        return acc

    monkeypatch.setattr(scf_mod, "density_kset", poisoned)
    ctx = synthetic_silicon_context(gk_cutoff=3.0, pw_cutoff=7.0,
                                    ngridk=(2, 2, 2), num_bands=8,
                                    extra_params={"num_dft_iter": 4})
    ctx.cfg.control.scf_supervision = False
    with pytest.raises(FloatingPointError, match="non-finite"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")
    ctx.cfg.control.scf_supervision = True
    with pytest.raises(ScfAbortError) as err:
        run_scf(ctx.cfg, ctx=ctx, device="cpu")
    diag = err.value.diagnostic
    assert [h["action"] for h in diag["ladder_history"]] == [
        "flush_history", "halve_beta_linear", "disable_device_scf"]
    assert [h["sentinel"] for h in diag["ladder_history"]] == [
        "device_nonfinite"] * 3
    assert diag["sentinel"] == "nonfinite_fields"


def test_carry_restores_its_history():
    # init_carry's history, as the JAX package's rollback restores it:
    # a step from a carry seeded with fetch_state's mixed vector and history
    # gives the record of the run it was fetched from, bit for bit
    from sirius_tpu_torch.dft.fused import FusedScf

    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.mixer import Mixer
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.parallel.batched import make_hkset_params

    rng = np.random.default_rng(7)
    ctx = synthetic_silicon_context(gk_cutoff=3.0, pw_cutoff=7.0,
                                    ngridk=(2, 2, 2), num_bands=8,
                                    ultrasoft=False, use_symmetry=False)

    tables = grid_tables(ctx, "cpu")
    xc = XCFunctional(ctx.cfg.parameters.xc_functionals)
    x0 = torch.as_tensor(initial_density_g(ctx))
    pot = generate_potential(ctx, x0, xc, tables)
    ps = make_hkset_params(ctx, pot.veff_r_coarse.numpy(), device="cpu")

    def fresh():
        mixer = Mixer(ctx.cfg.mixer, ctx.gvec.glen2, ctx.unit_cell.omega,
                      device="cpu")
        return FusedScf(ctx, xc, mixer, False, tables, None, None, ps.beta,
                        ps.ekin, ps.mask)

    nk, nb, ngk = ctx.gkvec.num_kpoints, ctx.num_bands, ctx.gkvec.ngk_max
    psi = torch.as_tensor(rng.standard_normal((nk, 1, nb, ngk))
                          + 1j * rng.standard_normal((nk, 1, nb, ngk)))
    ev = torch.as_tensor(np.sort(rng.uniform(-0.4, 0.6, (nk, 1, nb))))
    kw = torch.as_tensor(ctx.kweights)
    occ_w = torch.full((nk, 1, nb), 0.5, dtype=torch.float64) * kw[:, None,
                                                                    None]
    ent = torch.zeros((), dtype=torch.float64)
    acc = [torch.as_tensor(rng.uniform(0.0, 0.1, (1,) + tables.dims_coarse))
           for _ in range(4)]
    first = fresh()
    first.init_carry(x0, pot)
    for a in acc[:3]:
        out = first.step(a, None, ev, occ_w, ent, psi)
    x, hist = first.fetch_state(with_history=True)
    assert hist["mix_x"].shape == (3, x.shape[0])
    second = fresh()
    second.init_carry(torch.as_tensor(x), out.pot, history=hist)
    want = first.step(acc[3], None, ev, occ_w, ent, psi).record
    got = second.step(acc[3], None, ev, occ_w, ent, psi).record
    assert torch.equal(got, want)
