"""chip_smoke.py off the card: without CUDA it exits non-zero and prints no
result, and its kernel and parity phases run end to end on the CPU at the
small decks, norm-conserving, ultrasoft + symmetry, Gamma-only, the
collinear GGA decks and SCAN (every wrapper then takes its plain version,
so the checks compare the plain versions with themselves and no launch is
counted). Its launch checks are held to what each band-solve path
launches, and its decks to the reference tool's."""

import importlib.util

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from sirius_tpu_torch.ops.gamma import apply_h_s_gamma  # noqa: E402
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
SMALL_GAMMA = dict(SMALL, ngridk=(1, 1, 1))
# the kernels check_kernels, check_kernels_us and check_kernels_gamma hold
# against their plain versions
NC_CHECKED = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
              "davidson_residual", "density_accumulate", "lda_xc")
US_CHECKED = ("veff_multiply", "augmentation.rho_aug",
              "augmentation.d_operator", "symmetrize_pw")
GAMMA_CHECKED = ("gamma_pack.unpack_to_box", "gamma_pack.box_to_packed_hx",
                 "veff_multiply.real", "davidson_residual.f64")
XC_CHECKED = tuple(chip_smoke.XC_CHECKS) + ("xc_gradient.gradient_boxes",
                                            "xc_gradient.divergence_pw")
TAU_CHECKED = ("mgga_tau.grad_to_box", "mgga_tau.box_to_pw_tau")


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference",
        os.path.join(ROOT, "tools", "torch_port_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def reference(deck):
    with open(os.path.join(ROOT, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        return json.load(f)["decks"][deck]


def test_exits_nonzero_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_phases_run_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT)
    recs = chip_smoke.check_kernels("small", ctx, dev, "cpu")
    assert sorted(recs) == sorted(NC_CHECKED)
    assert sorted(NC_CHECKED + US_CHECKED + GAMMA_CHECKED + ("beta_chunk",)
                  + XC_CHECKED + ("symmetrize_pw.axial",) + TAU_CHECKED) \
        == sorted(chip_smoke.SOURCE)
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    ref = reference("small")
    chip_smoke.parity_scf(ctx, dev, ref, "cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parity = [r for r in lines if r.get("phase") == "parity_scf"][0]
    assert parity["num_scf_iterations"] == ref["num_scf_iterations"]
    assert all(v == 0 for v in chip_smoke.read_launches().values())


def test_us_phases_run_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    recs = chip_smoke.check_kernels_us("small_us_sym", ctx, dev, "cpu")
    assert sorted(recs) == sorted(US_CHECKED)
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["library_ms"] is not None
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    ref = reference("small_us_sym")
    chip_smoke.parity_scf(ctx, dev, ref, "cpu", phase="parity_scf_us",
                          deck="small_us_sym", required=chip_smoke.US_KERNELS)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parity = [r for r in lines if r.get("phase") == "parity_scf_us"][0]
    assert parity["num_scf_iterations"] == ref["num_scf_iterations"]
    assert set(parity["launches"]) == set(chip_smoke.SOURCE)
    assert all(v == 0 for v in chip_smoke.read_launches().values())


def test_single_k_phases_run_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                  chip_smoke.US_SYM)
    recs = chip_smoke.check_kernels_gamma("small_gamma", ctx, dev, "cpu")
    for chunk in (1, 16):
        recs.update(chip_smoke.check_kernel_chunk("small_gamma", ctx, chunk,
                                                  dev, "cpu"))
    assert sorted(recs) == sorted(GAMMA_CHECKED + ("beta_chunk",))
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    name = "gamma_us_sym"
    path, required = chip_smoke.SINGLE_K_PATH[name]
    calls = apply_h_s_gamma.calls
    chip_smoke.parity_scf(chip_smoke.single_k_context(name), dev,
                          reference(name), "cpu", phase="parity_scf_gamma_us",
                          deck=name, required=required, path=path)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parity = [r for r in lines if r.get("phase") == "parity_scf_gamma_us"][0]
    assert parity["num_scf_iterations"] == reference(name)["num_scf_iterations"]
    assert apply_h_s_gamma.calls > calls
    assert all(v == 0 for v in chip_smoke.read_launches().values())


def test_xc_phases_run_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT)
    recs = chip_smoke.check_kernels_xc("small_gamma", ctx, dev, "cpu")
    assert sorted(recs) == sorted(XC_CHECKED)
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["library_ms"] is None
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    name = "small_gamma_pbe_fm"
    ref = reference(name)
    spec = dict(SMALL_GAMMA, ultrasoft=True, use_symmetry=True)
    from sirius_tpu_torch.testing import synthetic_silicon_context

    fm = synthetic_silicon_context(
        extra_params=dict(chip_smoke.TIGHT, xc_functionals=chip_smoke.PBE,
                          **chip_smoke.SPIN),
        moments=np.asarray(chip_smoke.FM), **spec)
    axial = chip_smoke.check_kernel_axial(name, fm, dev, "cpu")
    assert axial["symmetrize_pw.axial"]["max_rel_err"] == 0.0
    path, required = chip_smoke.XC_DECK_PATH["gamma_pbe_us_sym_fm"]
    launches = chip_smoke.parity_scf(fm, dev, ref, "cpu",
                                     phase="parity_scf_gamma_pbe_us_fm",
                                     deck=name, required=required, path=path)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    moments = [r for r in lines if "max_moment_err" in r][0]
    assert moments["max_moment_err"] <= 1e-6
    assert set(launches) == set(chip_smoke.SOURCE)
    assert all(v == 0 for v in launches.values())


def test_mgga_phases_run_on_cpu(monkeypatch, capsys):
    # K11a / K11b against their plain versions, then the small SCAN deck
    # through the parity phase with the SCAN path's kernels
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    recs = chip_smoke.check_kernels_tau("small_us_sym", ctx, dev, "cpu")
    assert sorted(recs) == sorted(TAU_CHECKED)
    for rec in recs.values():
        assert rec["max_rel_err"] == 0.0
        assert rec["library_ms"] is not None
        assert rec["bound_ms"] > 0 and rec["bound_by"] == "bytes"
    name = "small_scan_nc"
    ref = reference(name)
    shape, kind, _, params, _ = reference_tool().deck_spec(name)
    scan = chip_smoke.make_context(shape, params, kind)
    launches = chip_smoke.parity_scf(
        scan, dev, ref, "cpu", phase="parity_scf_scan_nc", deck=name,
        required=chip_smoke.xc_kernels(chip_smoke.NC_KERNELS, False, False,
                                       mgga=True))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parity = [r for r in lines if r.get("phase") == "parity_scf_scan_nc"][0]
    assert parity["num_scf_iterations"] == ref["num_scf_iterations"]
    assert set(launches) == set(chip_smoke.SOURCE)
    assert all(v == 0 for v in launches.values())
    assert set(chip_smoke.FULL_SCAN_KERNELS) >= set(chip_smoke.MGGA_KERNELS)
    assert "lda_xc" not in chip_smoke.FULL_SCAN_KERNELS
    assert set(chip_smoke.SUMMARY_MGGA) == {"mgga_xc.scan",
                                            "mgga_xc.scan.unpolarized",
                                            *TAU_CHECKED}


def test_decks_match_the_reference_tool():
    tool = reference_tool()
    for name, (shape, kind, params, moments) in chip_smoke.XC_DECKS.items():
        assert tool.deck_spec(name) == (shape, kind, {}, params, moments), name
        assert chip_smoke.XC_DECK_PATH[name][0] == (
            "gamma" if shape["ngridk"] == (1, 1, 1) else "kset")


def test_magnetic_supercell_context_tiles_like_the_helper():
    # at n = 1 the tiled cell is the helper's 2-atom cell with the moments
    from sirius_tpu_torch.testing import synthetic_silicon_context

    extra = {"num_mag_dims": 1, "xc_functionals": chip_smoke.PBE}
    got = chip_smoke.magnetic_supercell_context(
        1, SMALL_GAMMA, extra, chip_smoke.US_SYM, 0.5)
    want = synthetic_silicon_context(extra_params=extra,
                                     moments=np.asarray(chip_smoke.FM),
                                     **chip_smoke.US_SYM,
                                     **dict(SMALL_GAMMA, num_bands=None))
    for a, b in ((got.unit_cell.positions, want.unit_cell.positions),
                 (got.unit_cell.lattice, want.unit_cell.lattice),
                 (got.unit_cell.moments, want.unit_cell.moments),
                 (got.gvec.millers, want.gvec.millers)):
        np.testing.assert_array_equal(a, b)
    assert got.symmetry.num_ops == want.symmetry.num_ops
    assert got.num_spins == 2 and got.num_bands == want.num_bands


def test_launch_checks_follow_the_band_solve_path():
    # on the card: a path's kernels must each launch, and on the Gamma path
    # K1's gather serves only the r -> G transforms (2 iters + 1)
    cuda = torch.device("cuda")
    launches = {name: 1 for name in chip_smoke.SOURCE}
    launches["local_hpsi.box_to_pw_hpsi"] = 7
    chip_smoke.check_launched("gamma", cuda, launches,
                              chip_smoke.GAMMA_US_KERNELS, "gamma", 3)
    with pytest.raises(AssertionError, match="H psi went through K1"):
        chip_smoke.check_launched("gamma", cuda, launches,
                                  chip_smoke.GAMMA_US_KERNELS, "gamma", 4)
    launches["beta_chunk"] = 0
    with pytest.raises(AssertionError, match="beta_chunk"):
        chip_smoke.check_launched("chunked", cuda, launches,
                                  chip_smoke.CHUNKED_US_KERNELS, "chunked", 3)
    chip_smoke.check_launched("kset", cuda, launches, chip_smoke.US_KERNELS)
    # polarized Gamma: two r -> G transforms a potential (V_xc, B_z)
    launches["beta_chunk"] = 1
    launches["local_hpsi.box_to_pw_hpsi"] = 2 * 4 + 3
    chip_smoke.check_launched("gamma_fm", cuda, launches,
                              chip_smoke.FULL_GAMMA_PBE_FM_KERNELS, "gamma", 3,
                              polarized=True)
    launches["symmetrize_pw.axial"] = 0
    with pytest.raises(AssertionError, match="symmetrize_pw.axial"):
        chip_smoke.check_launched("gamma_fm", cuda, launches,
                                  chip_smoke.FULL_GAMMA_PBE_FM_KERNELS,
                                  "gamma", 3, polarized=True)
