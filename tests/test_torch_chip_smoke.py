"""chip_smoke.py off the card: without CUDA it exits non-zero and prints no
result, and its kernel and parity phases run end to end on the CPU at the
small decks, norm-conserving, ultrasoft + symmetry, Gamma-only, the
collinear GGA decks, SCAN, the potential's passes and non-collinear spin (every wrapper then takes
its plain version,
so the checks compare the plain versions with themselves and no launch is
counted). Its launch checks are held to what each band-solve path
launches, and its decks to the reference tool's."""

import importlib.util

import json
import math
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
SPINOR_CHECKED = ("spinor_veff", "density_accumulate_nc",
                  "symmetrize_vector_pw", "augmentation.rho_aug.4",
                  "augmentation.d_operator.4")
# K4 at the 54-atom cell, one channel and two (check_kernels_aug54)
AUG54_CHECKED = ("augmentation.rho_aug.54", "augmentation.rho_aug.2.54")
# the fp32 instantiations the fp32 modes of the checks hold
FP32_CHECKED = tuple(chip_smoke.FP32_SUMMARY)
# K4 on the stress's strained tables (check_rho_aug_strained)
STRAINED_CHECKED = ("augmentation.rho_aug.strained",)
# the fused step's K13, K14a, K14b and K15 (check_fused_kernels)
FUSED_CHECKED = ("fermi", "mixer.gram", "mixer.update", "scf_record")
# K16a, K16b and K18 (check_density_hdiag_kernels)
SCATTER_CHECKED = ("density_scatter.coarse_box",
                   "density_scatter.scatter_fine", "h_diag")
# K17a-K17d (check_potential_kernels): every pass polarized at 16 and 54
# atoms, and the 16-atom records of the unpolarized X + PZ passes
K17 = ("potential_passes.xc_inputs", "potential_passes.xc_outputs",
       "potential_passes.hartree_veff", "potential_passes.gga_inputs",
       "potential_passes.coarse_fill", "potential_passes.coarse_stack")
GGA_INPUTS = "potential_passes.gga_inputs"
POTENTIAL_CHECKED = K17 + tuple(k + ".54" for k in K17) + tuple(
    k + ".unpolarized" for k in K17 if k != GGA_INPUTS)


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
    assert (sorted(NC_CHECKED + US_CHECKED + GAMMA_CHECKED + ("beta_chunk",)
                  + XC_CHECKED + ("symmetrize_pw.axial",) + TAU_CHECKED
                  + SPINOR_CHECKED + AUG54_CHECKED + FP32_CHECKED
                  + STRAINED_CHECKED + FUSED_CHECKED + SCATTER_CHECKED
                  + POTENTIAL_CHECKED)
            == sorted(chip_smoke.SOURCE))
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


@pytest.mark.parametrize("fp32", [False, True])
def test_gather_records_carry_plans_and_device_time(monkeypatch, fp32):
    # K8b's record says it is bitwise its plain version and which kernel
    # and grid it launched; K9's its grid; every record has a device time
    # (None off the card)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                  chip_smoke.US_SYM)
    sfx_r, sfx_c = (".f32", ".c64") if fp32 else ("", "")
    recs = chip_smoke.check_kernels_gamma("small_gamma", ctx, dev, "cpu",
                                          fp32=fp32)
    recs.update(chip_smoke.check_kernel_chunk("small_gamma", ctx, 16, dev,
                                              "cpu", fp32=fp32))
    k8b = recs["gamma_pack.box_to_packed_hx" + sfx_r]
    assert k8b["bitwise"] is True and k8b["max_abs_err"] == 0.0
    assert k8b["plan"]["rows_per_thread"] == 2
    assert k8b["plan"]["blocks"][1] == ctx.num_bands  # 2 nb rows
    k9 = recs["beta_chunk" + sfx_c]
    assert k9["plan"]["blocks"][1] == 16
    assert all("device_ms" in r and r["device_ms"] is None
               for r in recs.values())


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
    # K7, K7b, K7g and K7s: each record names the instantiation it ran, the
    # decks' sets their own, the other lists the runtime mask, all held to
    # 1e-12
    kinds = {name: rec["instantiation"] for name, rec in recs.items()
             if name.startswith(("lda_xc", "gga_xc", "mgga_xc"))}
    assert kinds == {
        "lda_xc.pz": "pz", chip_smoke.PZ0: "pz", "lda_xc.pw92": "pw92",
        "lda_xc.pw92.unpolarized": "pw92", "lda_xc.vwn": "vwn",
        "lda_xc.vwn.unpolarized": "vwn", "lda_xc.mask": "mask",
        "lda_xc.mask.unpolarized": "mask",
        "gga_xc.pbe": "pbe", "gga_xc.pbe.unpolarized": "pbe",
        "gga_xc.pbesol": "pbesol", "gga_xc.pbesol.unpolarized": "pbesol",
        "mgga_xc.scan": "scan", "mgga_xc.scan.unpolarized": "scan",
        "gga_xc.mask": "mask", "gga_xc.mask.unpolarized": "mask",
        "mgga_xc.mask": "mask", "mgga_xc.mask.unpolarized": "mask"}
    assert all(recs[name]["tol_rel"] == 1e-12 for name in kinds)
    # unpolarized X + PZ bit for bit its polarized launch at (rho/2, rho/2),
    # K10a bit for bit its plain version on two fields and on one
    assert recs[chip_smoke.PZ0]["bitwise_polarized"] is True
    k10a = recs["xc_gradient.gradient_boxes"]
    assert k10a["bitwise_1_fields"] is True
    assert k10a["bitwise_2_fields"] is True
    assert k10a["max_abs_err"] == 0.0
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
    # the spinor decks are the tool's own, each with its kernel list
    assert set(chip_smoke.SPINOR_DECK_PATH) == set(tool.SPINOR_DECKS)
    ctx = chip_smoke.deck_context("small_spinor_us", tool)
    shape, kind, _, params, moments = tool.deck_spec("small_spinor_us")
    np.testing.assert_array_equal(ctx.unit_cell.moments, np.asarray(moments))
    assert ctx.num_mag_dims == 3 and ctx.num_bands == shape["num_bands"]
    assert ctx.cfg.parameters.num_dft_iter == params["num_dft_iter"]


def test_spinor_phases_run_on_cpu(monkeypatch, capsys):
    # K12a, K12b, K6v and four-channel K4 against their plain versions on
    # the 6-op canted deck, then the Gamma-only spinor deck through the
    # parity phase with the spinor path's kernels and vector moments
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    ctx = chip_smoke.deck_context("small_spinor_pbe_us_sym")
    assert ctx.symmetry.num_ops == 6
    recs = chip_smoke.check_kernels_spinor("small_spinor_pbe_us_sym", ctx, dev,
                                           "cpu")
    assert sorted(recs) == sorted(SPINOR_CHECKED)
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
    # one PyTorch call computes each but K12b
    assert [n for n, r in recs.items() if r["library_ms"] is None] == [
        "density_accumulate_nc"]
    # the yardstick computes the same function
    name = "small_spinor_us"
    ref = reference(name)
    launches = chip_smoke.parity_scf(
        chip_smoke.deck_context(name), dev, ref, "cpu",
        phase="parity_scf_" + name, deck=name,
        required=chip_smoke.SPINOR_DECK_PATH[name], path="kset_nc")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parity = [r for r in lines if r.get("phase") == "parity_scf_" + name]
    assert parity[0]["num_scf_iterations"] == ref["num_scf_iterations"]
    assert parity[1]["max_moment_err"] <= 1e-8
    assert len(parity[1]["total_moment"]) == 3
    assert set(launches) == set(chip_smoke.SOURCE)
    assert all(v == 0 for v in launches.values())


def test_spinor_yardstick_is_the_symmetrization(monkeypatch):
    # K6v's library yardstick (index_add_ over a dense scatter table)
    # computes the same field as the kernel's plain version
    seen = {}

    def keep(out, deck, gpu, name, kernel_out, plain_out, fn_k, fn_p, fn_lib,
             nbytes, flops, slow_plain=False, extra=None, tensor_flops=0.0):
        if name == "symmetrize_vector_pw":
            seen["lib"], seen["plain"] = fn_lib(), plain_out[0]

    monkeypatch.setattr(chip_smoke, "record_kernel", keep)
    ctx = chip_smoke.deck_context("small_spinor_pbe_us_sym")
    chip_smoke.check_kernels_spinor("small_spinor_pbe_us_sym", ctx,
                                    torch.device("cpu"), "cpu")
    err = (seen["lib"] - seen["plain"]).abs().max() / seen["plain"].abs().max()
    assert float(err) <= 1e-13


@pytest.mark.parametrize("name", ["spinor_veff", "augmentation.rho_aug.4"])
def test_spinor_yardsticks_compute_the_kernels_function(monkeypatch, name):
    # K12a's einsum over the [2, 2, n] potential and K4's einsum on four
    # channels compute the same fields as the kernels' plain versions
    seen = {}

    def keep(out, deck, gpu, rec_name, kernel_out, plain_out, fn_k, fn_p,
             fn_lib, nbytes, flops, slow_plain=False, extra=None,
             tensor_flops=0.0):
        if rec_name == name:
            seen["lib"], seen["plain"] = fn_lib(), plain_out[0]

    monkeypatch.setattr(chip_smoke, "record_kernel", keep)
    ctx = chip_smoke.deck_context("small_spinor_pbe_us_sym")
    chip_smoke.check_kernels_spinor("small_spinor_pbe_us_sym", ctx,
                                    torch.device("cpu"), "cpu")
    lib, plain = seen["lib"], seen["plain"]
    assert lib.shape == plain.shape
    err = (lib - plain).abs().max() / plain.abs().max()
    assert float(err) <= 1e-13


MAGNETIC = {"total": [1.0, 0.0, 1.0], "atoms": [[0.5, 0.0, 0.5]] * 2}
ROTATED = {"total": [2 ** 0.5, 0.0, 0.0], "atoms": [[2 ** -0.5, 0.0, 0.0]] * 2}
NOISE = {"total": [3.5e-8] * 3, "atoms": [[1e-9] * 3] * 2}
ZERO = {"total": [0.0] * 3, "atoms": [[0.0] * 3] * 2}


@pytest.mark.parametrize("got,want,symmetric,compared,ok", [
    (ROTATED, MAGNETIC, False, "magnitudes and dot products", True),
    (ROTATED, MAGNETIC, True, "components", False),
    (MAGNETIC, MAGNETIC, True, "components", True),
    (NOISE, ZERO, True, "non-magnetic: components", True),
    ({"total": [2e-7] * 3, "atoms": [[1e-9] * 3] * 2}, ZERO, True,
     "non-magnetic: components", False),
], ids=["axis_turned", "axis_pinned", "same", "noise", "noise_too_large"])
def test_spinor_moment_errors_compare_what_the_physics_fixes(
        got, want, symmetric, compared, ok):
    # a common rotation passes without a group and fails with one; a
    # non-magnetic record takes the JAX package's own run-to-run spread
    errs = chip_smoke.spinor_moment_errors(got, want, symmetric)
    assert errs["compared"] == compared
    assert (errs["max_moment_err"] <= errs["moment_tol"]) == ok
    if compared.startswith("non-magnetic"):
        assert errs["moment_tol"] == chip_smoke.NONMAGNETIC_MOMENT_TOL == 1e-7


def test_reference_spread_takes_spinor_decks_only():
    with pytest.raises(ValueError, match="spinor decks"):
        reference_tool().spread(["small"])


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
    # a moment vector: the non-collinear canted cell
    extra = {"num_mag_dims": 3}
    got = chip_smoke.magnetic_supercell_context(
        1, SMALL_GAMMA, extra, chip_smoke.US_SYM, chip_smoke.CANTED[0])
    want = synthetic_silicon_context(extra_params=extra,
                                     moments=np.asarray(chip_smoke.CANTED),
                                     **chip_smoke.US_SYM,
                                     **dict(SMALL_GAMMA, num_bands=None))
    np.testing.assert_array_equal(got.unit_cell.moments,
                                  want.unit_cell.moments)
    assert got.symmetry.num_ops == want.symmetry.num_ops == 6


def test_real_mode_bound_counts_whole_elements(monkeypatch):
    # K1c real mode's bytes: every complex element of [1, 2 nb, n] read and
    # written whole (a warp's reads of the real halves fetch every sector),
    # the potential once
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                  chip_smoke.US_SYM)
    n = int(np.prod(ctx.fft_coarse.dims))
    rows = 2 * ctx.num_bands
    for fp32, (cb, rb) in ((False, (16, 8)), (True, (8, 4))):
        recs = chip_smoke.check_kernels_gamma("small_gamma", ctx,
                                              torch.device("cpu"), "cpu",
                                              fp32=fp32)
        rec = recs["veff_multiply.real" + (".c64" if fp32 else "")]
        assert rec["bytes"] == rows * n * 2 * cb + n * rb
        assert rec["bitwise"]
        assert rec["bound_ms"] == pytest.approx(
            rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_edge_shapes_run_on_cpu(capsys):
    # the K1c, K5 and K8b edge cases: each K1c case bitwise, with its view
    # off a 16-byte boundary where it says so; K5 at every channel count,
    # below one tile and past one launch group, to 1e-12 and
    # repeat-bitwise
    chip_smoke.check_kernel_edges(torch.device("cpu"), "cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    k1c = [r for r in lines if r["name"].startswith("veff_multiply")]
    assert len(k1c) == 4 * len(chip_smoke.K1C_EDGES)
    assert all(r["bitwise"] for r in k1c)
    assert {r["fr_offset_bytes"] for r in k1c
            if r["name"].endswith(".c64") and r["offset_elements"]} == {8}
    k5 = [r for r in lines if r["name"] == "augmentation.d_operator"]
    assert {r["channels"] for r in k5} == {1, 2, 4}
    assert any(r["num_gvec"] < r["plan"]["tg"] for r in k5)
    assert any(r["plan"]["ngroups"] > 1 for r in k5)
    assert all(r["num_gvec"] % r["plan"]["chunk"] for r in k5)
    assert all(r["max_rel_err"] <= 1e-12 and r["repeat_bitwise"] for r in k5)
    # K8b in both instantiations on a half tile, one row and padding slots
    k8b = [r for r in lines if r["name"].startswith("gamma_pack")]
    assert len(k8b) == 2 * len(chip_smoke.K8B_EDGES)
    assert all(r["bitwise"] for r in k8b)
    assert {r["rows"] % r["plan"]["rows_per_thread"] for r in k8b} == {1}
    assert {r["padding_slots"] > 0 for r in k8b} == {True, False}
    # K10a bit for bit on 1, 2 and 3 fields, off the 256-thread block, a G
    # at the box's last slot
    k10a = [r for r in lines if r["name"] == "xc_gradient.gradient_boxes"]
    assert {r["fields"] for r in k10a} == {1, 2, 3}
    assert all(r["bitwise"] and r["last_slot_live"] for r in k10a)
    assert any(r["nbox"] % 256 for r in k10a)


def test_rho_aug_edges_run_on_cpu(capsys):
    # K4 at every case of K4_EDGES on 1, 2 and 4 channels, to 1e-12, with
    # G = 0 its own row; the cases plant what they name
    chip_smoke.check_rho_aug_edges(torch.device("cpu"), "cpu",
                                   np.random.default_rng(43))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {(r["case"], r["channels"]) for r in lines} == {
        (c[0], ns) for c in chip_smoke.K4_EDGES for ns in (1, 2, 4)}
    assert len(lines) == 3 * len(chip_smoke.K4_EDGES)
    assert all(r["name"] == "augmentation.rho_aug" and r["g0_row_self"]
               and r["max_rel_err"] <= 1e-12 for r in lines)
    by = {(r["case"], r["channels"]): r for r in lines}
    for ns in (1, 2, 4):
        assert by["below one row tile", ns]["rows"] < 32
        assert by["off the row tile", ns]["rows"] % 32
        assert by["one atom", ns]["atoms"] == 1
        assert by["tile shrinks", ns]["plan"]["tg"] < 128
        assert by["atom tiles", ns]["plan"]["atom_tiles"] > 1
        assert {by["nqlm 3", ns]["nqlm"], by["nqlm 15", ns]["nqlm"]} == {3, 15}
        assert by["q split, nqlm 15", ns]["nqlm"] == 15
        last = by["G = 0 last", ns]
        assert last["g0_index"] == last["num_gvec"] - 1
    # one channel at 54 atoms splits q over two threads a row
    for case in ("tile shrinks", "q split, nqlm 15"):
        assert by[case, 1]["plan"]["ksplit"] == 2


def test_aug54_records_run_on_cpu(monkeypatch):
    # the 54-atom K4 records on a small deck: one channel returned, two
    # into the FM dict, each with its plan and the einsum yardstick
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                  chip_smoke.US_SYM)
    fm = {}
    recs = chip_smoke.check_kernels_aug54("small_gamma", ctx,
                                          torch.device("cpu"), "cpu", fm)
    assert sorted(recs) + sorted(fm) == list(AUG54_CHECKED)
    for ns, rec in ((1, recs[AUG54_CHECKED[0]]), (2, fm[AUG54_CHECKED[1]])):
        assert rec["channels"] == ns and rec["max_rel_err"] <= 1e-12
        assert rec["plan"]["threads"] == ns * rec["plan"]["tg"]
        assert rec["library_ms"] is not None and rec["bound_ms"] > 0
        # the bound counts the phases and the atom sum (at the tensor-core
        # rate) once a (G, -G) row, the contraction for every G
        na, ng, nrow = rec["atoms"], rec["num_gvec"], rec["rows"]
        assert 2 * nrow - 1 == ng
        nqlm = (rec["flops"] - nrow * na * 7.0) / (ng * ns * 8.0)
        assert nqlm == int(nqlm) >= 1
        assert rec["tensor_flops"] == nrow * na * ns * nqlm * 4.0
        assert (rec["bound_ms"], rec["bound_by"]) == chip_smoke.bound(
            rec["bytes"], rec["flops"], tensor_flops=rec["tensor_flops"])
    assert fm[AUG54_CHECKED[1]]["deck"] == "small_gamma_fm"


def test_xc_edges_run_on_cpu(capsys):
    # every K7, K7b, K7g and K7s instantiation at every XC edge case, to
    # 1e-12 and finite; the cases plant what they name
    from sirius_tpu_torch.kernels.xc_functionals import DENS_TH

    rng = np.random.default_rng(41)
    chip_smoke.check_xc_edges(torch.device("cpu"), "cpu", rng)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    names = list(chip_smoke.XC_CHECKS)
    assert {n.split(".")[0] for n in names} == {"lda_xc", "gga_xc",
                                                "mgga_xc"}
    pz0_cases = [c for c, _ in chip_smoke.PZ0_EDGES]
    pz0 = [r for r in lines if r["name"] == chip_smoke.PZ0
           and "bitwise_polarized" in r]
    lines = [r for r in lines if "bitwise_polarized" not in r]
    want = {(n, c) for n in names for c, _ in chip_smoke.XC_EDGES
            if n.startswith("lda_xc") or c not in chip_smoke.LDA_ONLY_EDGES}
    assert len(lines) == len(want)
    assert {(r["name"], r["case"]) for r in lines} == want
    assert all(r["max_rel_err"] <= 1e-12 and r["finite"] for r in lines)
    # polarized X + PZ at n_up = n_dn bit for bit the zeta = 0 kernel
    tie = [r for r in lines if "bitwise_zeta0" in r]
    assert [(r["name"], r["case"]) for r in tie] == [("lda_xc.pz",
                                                      "n_up == n_dn")]
    assert tie[0]["bitwise_zeta0"] is True
    # unpolarized X + PZ at its own cases, bit for bit its polarized launch
    assert [r["case"] for r in pz0] == pz0_cases
    assert all(r["max_rel_err"] <= 1e-12 and r["finite"]
               and r["bitwise_polarized"] for r in pz0)
    cpu = torch.device("cpu")
    f = chip_smoke.xc_edge_fields("one point", 1, rng, cpu)
    assert f["nu"].shape == (1,) and f["gu"].shape == (3, 1)
    f = chip_smoke.xc_edge_fields("off the block", 933, rng, cpu)
    assert f["nu"].shape[0] % 128
    f = chip_smoke.xc_edge_fields("all dead", 933, rng, cpu)
    assert bool((f["nu"] < DENS_TH).all() and (f["nd"] < DENS_TH).all())
    # each half channel just live (at DENS_TH) or just dead (below it)
    f = chip_smoke.xc_edge_fields("at and below 2 DENS_TH", 933, rng, cpu)
    half = 0.5 * f["rho"]
    assert bool((half[::2] == DENS_TH).all() and (half[1::2] < DENS_TH).all())
    f = chip_smoke.xc_edge_fields("sigma 0 at zeta +-1", 933, rng, cpu)
    assert float(f["gu"].abs().max()) == float(f["gd"].abs().max()) == 0.0
    assert bool(((f["nu"] == 0) | (f["nd"] == 0)).all())
    assert bool((f["nu"] == 0).any() and (f["nd"] == 0).any())
    f = chip_smoke.xc_edge_fields("fully polarized", 933, rng, cpu)
    assert bool(((f["nu"] == 0) | (f["nd"] == 0)).all())
    assert float(f["gu"].abs().max()) > 0.0
    # both channels live, zeta at +-1 itself or a few ulp from it
    f = chip_smoke.xc_edge_fields("zeta within ulp of +-1", 933, rng, cpu)
    assert bool((f["nu"] >= DENS_TH).all() and (f["nd"] >= DENS_TH).all())
    zeta = ((f["nu"] - f["nd"]) / (f["nu"] + f["nd"])).abs()
    assert bool((zeta == 1.0).any() and (zeta < 1.0).any())
    assert float((1.0 - zeta).max()) <= 1.6e-15
    assert bool((f["rho"] == f["nu"] + f["nd"]).all())
    # equal channels summing to rho exactly, dead and threshold points first
    f = chip_smoke.xc_edge_fields("n_up == n_dn", 933, rng, cpu)
    assert bool((f["nu"] == f["nd"]).all() and (f["nu"] + f["nd"] == f["rho"]
                                                 ).all())
    half = 0.5 * f["rho"][:4]
    assert bool((half[:2] < DENS_TH).all() and half[2] == DENS_TH
                and half[3] < DENS_TH)
    # SCAN's alpha of each channel, (tau - tau_W) / tau_unif, at 1
    f = chip_smoke.xc_edge_fields("alpha at 1", 933, rng, cpu)
    tau_w = (f["gu"] ** 2).sum(0) / (8.0 * f["nu"])
    tau_unif = 0.3 * (6.0 * math.pi**2) ** (2.0 / 3.0) * f["nu"] ** (5 / 3)
    alpha = (f["tu"] - tau_w) / tau_unif
    assert float((alpha - 1.0).abs().max()) <= 1e-12


def test_eigh_calls_are_counted_by_type_and_order():
    # the full-width records name the eigh route they ran: a float32
    # Rayleigh-Ritz on the CPU runs both its eigh in float32, of its order
    from sirius_tpu_torch.solvers.davidson import _rayleigh_ritz

    rng = np.random.default_rng(3)
    v = rng.standard_normal((1, 12, 40))
    s = torch.as_tensor(v @ v.transpose(0, 2, 1), dtype=torch.float32)
    with chip_smoke.watch_eigh() as calls:
        _rayleigh_ritz(s + 0.0, s, 4)
    assert calls == {"torch.float32 12": 2}


def test_eigh_empty_rows_phase_runs_on_cpu(capsys):
    # the card's phase on the CPU: LAPACK solves the matrix, the Jacobi
    # wrapper is LAPACK, and the Ritz values are the CPU's own
    chip_smoke.check_eigh_empty_rows(torch.device("cpu"), "cpu")
    rec = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["phase"] for r in rec] == ["eigh_empty_rows"]
    assert rec[0]["empty_rows"] == 12 and rec[0]["raw_eigh"] == "converged"
    assert rec[0]["max_abs_err"] == 0.0 and rec[0]["jacobi_launches"] == 0


def test_launch_checks_follow_the_band_solve_path():
    # on the card: a path's kernels must each launch, and on the Gamma path
    # K1's gather serves only the potential's r -> G transforms (iters + 1;
    # the density's is K16's)
    cuda = torch.device("cuda")
    launches = {name: 1 for name in chip_smoke.SOURCE}
    launches["local_hpsi.box_to_pw_hpsi"] = 4
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
    # an unpolarized X + PZ deck launches K7's zeta = 0 kernel; no deck of
    # other functionals or spin needs it
    launches[chip_smoke.PZ0] = 0
    with pytest.raises(AssertionError, match=chip_smoke.PZ0):
        chip_smoke.check_launched("kset", cuda, launches,
                                  chip_smoke.US_KERNELS)
    for _, required in chip_smoke.XC_DECK_PATH.values():
        assert chip_smoke.PZ0 not in required
    launches[chip_smoke.PZ0] = 1
    # an LDA deck of other functionals launches its own K7b instantiation,
    # a non-collinear LDA deck the polarized X + PZ kernel; GGA decks none
    # of K7's
    for deck, name in (("pw_us_sym_afm", "lda_xc.pw92"),
                       ("gamma_nc_vwn", "lda_xc.vwn.unpolarized")):
        path, required = chip_smoke.XC_DECK_PATH[deck]
        launches[name] = 0
        with pytest.raises(AssertionError, match=name):
            chip_smoke.check_launched(deck, cuda, launches, required, path)
        launches[name] = 1
    for required in (chip_smoke.SPINOR_DECK_PATH["spinor_us"],
                     chip_smoke.SPINOR_SYM_KERNELS,
                     chip_smoke.FP32_SPINOR_SYM_KERNELS):
        assert "lda_xc.pz" in required
    for required in (chip_smoke.SPINOR_DECK_PATH["spinor_pbe_us_sym"],
                     chip_smoke.XC_DECK_PATH["pbe_us_sym"][1]):
        assert not [k for k in required if k.startswith("lda_xc")]
    # polarized Gamma: two r -> G transforms a potential (V_xc, B_z)
    launches["beta_chunk"] = 1
    launches["local_hpsi.box_to_pw_hpsi"] = 2 * 4
    chip_smoke.check_launched("gamma_fm", cuda, launches,
                              chip_smoke.FULL_GAMMA_PBE_FM_KERNELS, "gamma", 3,
                              polarized=True)
    launches["symmetrize_pw.axial"] = 0
    with pytest.raises(AssertionError, match="symmetrize_pw.axial"):
        chip_smoke.check_launched("gamma_fm", cuda, launches,
                                  chip_smoke.FULL_GAMMA_PBE_FM_KERNELS,
                                  "gamma", 3, polarized=True)
    # the spinor path launches K12a and K12b, never K1c or K3
    with pytest.raises(AssertionError, match="scalar kernels"):
        chip_smoke.check_launched("spinor", cuda, launches,
                                  chip_smoke.SPINOR_SYM_KERNELS, "kset_nc", 3)
    launches["veff_multiply"] = launches["density_accumulate"] = 0
    chip_smoke.check_launched("spinor", cuda, launches,
                              chip_smoke.SPINOR_SYM_KERNELS, "kset_nc", 3)
    launches["spinor_veff"] = 0
    with pytest.raises(AssertionError, match="spinor_veff"):
        chip_smoke.check_launched("spinor", cuda, launches,
                                  chip_smoke.SPINOR_SYM_KERNELS, "kset_nc", 3)
    # every path launches K16a, K16b and K18
    launches["spinor_veff"] = 1
    for name in chip_smoke.EVERY_PATH:
        launches[name] = 0
        with pytest.raises(AssertionError, match=name):
            chip_smoke.check_launched("kset", cuda, launches,
                                      chip_smoke.US_KERNELS)
        launches[name] = 1


def test_fp32_kernel_phases_run_on_cpu(monkeypatch):
    # every fp32 instantiation against its plain version (here the plain
    # version against itself), named, bound against fp32 rates and element
    # sizes, and summarized from the run that launches it
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    dev = torch.device("cpu")
    us = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    gamma = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                    chip_smoke.US_SYM)
    recs = chip_smoke.check_kernels("small_us_sym", us, dev, "cpu", fp32=True)
    recs.update(chip_smoke.check_kernels_us("small_us_sym", us, dev, "cpu",
                                            fp32=True))
    recs.update(chip_smoke.check_kernels_gamma("small_gamma", gamma, dev, "cpu",
                                               fp32=True))
    recs.update(chip_smoke.check_kernel_chunk("small_gamma", gamma, 16, dev,
                                              "cpu", fp32=True))
    recs.update(chip_smoke.check_kernels_tau("small_us_sym", us, dev, "cpu",
                                             fp32=True))
    recs.update(chip_smoke.check_kernels_spinor(
        "small_spinor_pbe_us_sym",
        chip_smoke.deck_context("small_spinor_pbe_us_sym"), dev, "cpu",
        fp32=True))
    assert sorted(recs) == sorted(FP32_CHECKED)
    for name, rec in recs.items():
        assert rec["tol_rel"] == 1e-5 and rec["max_rel_err"] <= 1e-5
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                           "operations")
        base = chip_smoke.base_name(name)
        assert chip_smoke.SOURCE[name] == chip_smoke.SOURCE[base]
        assert chip_smoke.REPLACES[name] == chip_smoke.REPLACES[base]
    # fp32 operations are counted at the fp32 rate
    b64, _ = chip_smoke.bound(0.0, 67e9)
    b32, _ = chip_smoke.bound(0.0, 67e9, fp32=True)
    assert b32 == pytest.approx(1.0) and b64 == pytest.approx(67 / 34)
    # each summary row's launches come from a run that launches it
    paths = {**chip_smoke.FP32_DECK_PATH,
             "full_width_us_fp32": ("kset", chip_smoke.FP32_US_KERNELS),
             "full_width_gamma_us_fp32": ("gamma",
                                          chip_smoke.FP32_GAMMA_US_KERNELS),
             "full_width_spinor_us_fp32": (
                 "kset_nc", chip_smoke.FP32_SPINOR_SYM_KERNELS)}
    for name, run in chip_smoke.FP32_SUMMARY.items():
        assert name in paths[run][1], (name, run)
    wr = chip_smoke.wrappers()
    for name in FP32_CHECKED:
        fn, attr = wr[name]
        assert attr == "launches_" + name.rsplit(".", 1)[1]
        assert getattr(fn, attr) == 0


@pytest.mark.parametrize("name", ["local_hpsi.pw_to_box.c64",
                                  "veff_multiply.c64",
                                  "veff_multiply.real.c64",
                                  "mgga_tau.grad_to_box.c64",
                                  "spinor_veff.c64"])
def test_fp32_yardsticks_compute_the_kernels_function(monkeypatch, name):
    # the one-call PyTorch yardsticks of the fp32 rows, given the same
    # complex64 inputs, compute what the kernels' plain versions compute
    seen = {}

    def keep(out, deck, gpu, rec_name, kernel_out, plain_out, fn_k, fn_p,
             fn_lib, nbytes, flops, slow_plain=False, extra=None,
             tensor_flops=0.0):
        if rec_name == name:
            seen["plain"] = plain_out[0].clone()
            seen["lib"] = fn_lib()

    monkeypatch.setattr(chip_smoke, "record_kernel", keep)
    dev = torch.device("cpu")
    if name.startswith("spinor"):
        ctx = chip_smoke.deck_context("small_spinor_pbe_us_sym")
        chip_smoke.check_kernels_spinor("s", ctx, dev, "cpu", fp32=True)
    elif name == "veff_multiply.real.c64":
        ctx = chip_smoke.make_context(SMALL_GAMMA, chip_smoke.TIGHT,
                                      chip_smoke.US_SYM)
        chip_smoke.check_kernels_gamma("g", ctx, dev, "cpu", fp32=True)
    else:
        ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT,
                                      chip_smoke.US_SYM)
        check = {"local_hpsi.pw_to_box.c64": chip_smoke.check_kernels,
                 "veff_multiply.c64": chip_smoke.check_kernels_us,
                 "mgga_tau.grad_to_box.c64": chip_smoke.check_kernels_tau}
        check[name]("s", ctx, dev, "cpu", fp32=True)
    lib, plain = seen["lib"], seen["plain"]
    if not lib.is_complex():
        # the real mode's yardstick multiplies the (re, im) pairs
        lib = torch.view_as_complex(lib)
    assert lib.dtype == torch.complex64 and plain.dtype == torch.complex64
    lib = lib.reshape(plain.shape)
    err = (lib - plain).abs().max() / plain.abs().max()
    assert float(err) <= 1e-6


def test_fp32_parity_phase_runs_on_cpu(capsys):
    # the polished and the fixed-count rules of the fp32 parity phase on the
    # deck of tests/test_precision.py (Gamma path), and the band-solve
    # watcher's record of each solve's precision
    dev = torch.device("cpu")
    with open(os.path.join(ROOT, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    tool = reference_tool()
    # on one torch thread, as tests/test_torch_precision.py::
    # test_fp32_polish_recovers_fp64 takes the polished deck (its stop at
    # 1e-11 moves with the rounding of the threaded sums)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in ("precision_us_fp32_polish", "precision_us_fp32_fixed10"):
            chip_smoke.parity_scf_fp32(chip_smoke.deck_context(name, tool),
                                       dev, refs, name, "cpu", path="gamma",
                                       required=())
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    pol, fixed = [r for r in lines if r.get("phase", "").startswith(
        "parity_scf_precision")]
    assert pol["polished"] and pol["term_limit"] == 1e-8
    assert pol["wf_precision"][0] == "fp32" and pol["wf_precision"][-1] == "fp64"
    assert [s["precision"] for s in pol["band_solves"]] == pol["wf_precision"]
    assert not fixed["polished"] and set(fixed["wf_precision"]) == {"fp32"}
    rec = refs["precision_us_fp32_fixed10"]
    assert fixed["term_limit"] == min(4 * rec["twin_max_gap"], 1e-4)
    assert fixed["electron_limit"] == 4 * rec["twin_electron_gap"]
    assert pol["electron_limit"] == 1e-8
    assert all(v == 0 for v in chip_smoke.read_launches().values())


def test_iteration_gate_takes_the_jax_span():
    # a count within +-1 of the JAX package's record and of its runs from
    # perturbed starts passes; one outside fails
    rec = {"num_scf_iterations": 12, "perturbed_iterations": [10, 13, 12]}
    assert chip_smoke.iteration_span(rec) == [10, 13]
    assert chip_smoke.iteration_span({"num_scf_iterations": 14}) == [14, 14]
    for n in (9, 12, 14):
        chip_smoke.check_iterations("p", n, rec)
    for n in (8, 15):
        with pytest.raises(AssertionError, match="the JAX package 10 to 13"):
            chip_smoke.check_iterations("p", n, rec)


def test_band_solve_check_follows_the_precision():
    # on the card an fp32 band solve may launch no fp64 band-solve kernel
    # and must launch an fp32 K2; fp64 solves and the density's fp64
    # kernels are not its concern
    cuda = torch.device("cuda")
    ok = [{"precision": "fp32",
           "launches": {"davidson_residual.c64": 21,
                        "local_hpsi.pw_to_box.c64": 25,
                        "density_accumulate": 1}},
          {"precision": "fp64", "launches": {"davidson_residual": 21}}]
    chip_smoke.check_band_solves("p", cuda, ok)
    bad = [{"precision": "fp32",
            "launches": {"davidson_residual.c64": 21, "veff_multiply": 1}}]
    with pytest.raises(AssertionError, match="fp64 kernels"):
        chip_smoke.check_band_solves("p", cuda, bad)
    with pytest.raises(AssertionError, match="no fp32 K2"):
        chip_smoke.check_band_solves("p", cuda, [
            {"precision": "fp32", "launches": {"spinor_veff.c64": 3}}])
    chip_smoke.check_band_solves("p", torch.device("cpu"), bad)


def test_fp32_decks_are_the_reference_tools():
    tool = reference_tool()
    assert set(chip_smoke.FP32_DECK_PATH) <= set(tool.FP32_TWINS)
    for name, (path, required) in chip_smoke.FP32_DECK_PATH.items():
        ctx = chip_smoke.deck_context(name, tool)
        assert ctx.cfg.parameters.precision_wf == "fp32"
        from sirius_tpu_torch.dft.scf import band_solve_path
        assert band_solve_path(ctx.cfg, ctx) == path
        assert all(k in chip_smoke.SOURCE for k in required)
    assert chip_smoke.deck_context("fp32_us_sym_polish", tool).cfg.settings\
        .fp32_to_fp64_rms == 1e-4


def test_force_gates_are_the_stated_ones():
    # the forces and stress phases' gates: 1e-6 Ha/bohr per force and
    # 1e-7 Ha/bohr^3 per stress component against the record; at full
    # width F[0, 0] against the central difference at +-2e-3 bohr to 5e-5
    # (tests/test_forces.py's bound), the net force to 1e-5, an SCF to
    # energy_tol 1e-10 and density_tol 1e-9 with atom 0 moved by 0.01 along
    # fractional x; K4 on one table set strained by eps_xy = 1e-5 to K4's
    # 1e-12
    assert chip_smoke.FORCE_TOL == 1e-6
    assert chip_smoke.STRESS_TOL == 1e-7
    assert chip_smoke.FORCE_FD_H == 2e-3
    assert chip_smoke.FORCE_FD_TOL == 5e-5
    assert chip_smoke.NET_FORCE_TOL == 1e-5
    assert chip_smoke.FORCE_SHIFT == (0.01, 0.0, 0.0)
    assert chip_smoke.FORCE_SCF["energy_tol"] == 1e-10
    assert chip_smoke.FORCE_SCF["density_tol"] == 1e-9
    assert chip_smoke.STRAIN_XY == 1e-5
    assert chip_smoke.TOL["augmentation.rho_aug.strained"] == \
        chip_smoke.TOL["augmentation.rho_aug"] == 1e-12


def test_force_decks_are_the_reference_tools():
    from sirius_tpu_torch.dft.scf import band_solve_path

    tool = reference_tool()
    assert tuple(chip_smoke.FORCES_DECK_PATH) == tool.FORCES_DECKS
    for name, (path, required, stress) in chip_smoke.FORCES_DECK_PATH.items():
        ctx = chip_smoke.deck_context(name, tool)
        assert ctx.cfg.control.print_forces and ctx.cfg.control.print_stress
        assert band_solve_path(ctx.cfg, ctx) == path
        assert all(k in chip_smoke.SOURCE for k in required + stress)
        # the stress launches K4 where the species are ultrasoft, K10a
        # where the functional is GGA
        assert ("augmentation.rho_aug" in stress) == (ctx.aug is not None)
        gga = any("GGA" in n for n in ctx.cfg.parameters.xc_functionals)
        assert ("xc_gradient.gradient_boxes" in stress) == gga


def test_force_checks_gate(capsys):
    ref = {"forces": [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
           "stress": np.zeros((3, 3)).tolist(), "forces_spread": 1e-9,
           "stress_spread": 1e-11}
    res = {"forces": [[5e-7, 0.0, 0.0], [0.0, 0.0, 0.0]],
           "stress": (np.eye(3) * 5e-8).tolist(), "forces_seconds": 0.1,
           "stress_seconds": 0.2, "stress_term_seconds": {}}
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    chip_smoke.check_forces("p", cpu, "cpu", "d", res, ref, {}, ("x",))
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["max_force_err"] == 5e-7 and rec["jax_force_spread"] == 1e-9
    with pytest.raises(AssertionError, match="forces off"):
        chip_smoke.check_forces("p", cpu, "cpu", "d",
                                dict(res, forces=[[2e-6, 0, 0], [0, 0, 0]]),
                                ref, {}, ())
    with pytest.raises(AssertionError, match="stress off"):
        chip_smoke.check_forces("p", cpu, "cpu", "d",
                                dict(res, stress=(np.eye(3) * 2e-7).tolist()),
                                ref, {}, ())
    # on the card the stress must have launched each kernel named
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_stress_launched("p", cuda, {"stress": {"a": 3}},
                                         ("a", "b"))
    chip_smoke.check_stress_launched("p", cuda, {"stress": {"a": 3, "b": 1}},
                                     ("a", "b"))


@pytest.mark.parametrize("name", ["forces_nc", "forces_us"])
def test_force_parity_phases_run_on_cpu(name, capsys):
    tool = reference_tool()
    path, required, _ = chip_smoke.FORCES_DECK_PATH[name]
    chip_smoke.parity_scf(chip_smoke.deck_context(name, tool),
                          torch.device("cpu"), reference(name), "cpu",
                          phase="parity_forces_" + name[7:], deck=name,
                          required=required, path=path)
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    forces = [r for r in recs if "max_force_err" in r]
    assert len(forces) == 1
    assert forces[0]["phase"] == "parity_forces_" + name[7:]
    assert forces[0]["max_force_err"] <= chip_smoke.FORCE_TOL
    assert forces[0]["max_stress_err"] <= chip_smoke.STRESS_TOL


def test_full_width_forces_runs_on_cpu(capsys):
    # the full-width phase on the 2-atom cell of the small shape (n = 1)
    chip_smoke.full_width_forces(torch.device("cpu"), "cpu", n=1,
                                 spec=SMALL)
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["phase"] == "full_width_forces_us"
    assert rec["band_solve"] == "kset" and rec["fused_d"]
    assert rec["fd_err"] <= chip_smoke.FORCE_FD_TOL
    assert rec["net_force"] <= chip_smoke.NET_FORCE_TOL
    assert rec["forces_seconds"] > 0 and rec["stress_seconds"] > 0
    assert len(rec["fd_iterations"]) == 2
    # atom 0 moved: the cell keeps fewer ops than the 48 of its sites
    assert 1 < rec["num_symmetry_ops"] < 48


def test_strained_rho_aug_record_runs_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    recs = chip_smoke.check_rho_aug_strained("small_us_sym", ctx,
                                             torch.device("cpu"), "cpu")
    rec = recs["augmentation.rho_aug.strained"]
    assert rec["max_rel_err"] <= 1e-12 and rec["strain_xy"] == 1e-5
    assert rec["bound_by"] == "bytes" and rec["library_ms"] is not None
    assert "augmentation.rho_aug.strained" in chip_smoke.wrappers()


def test_stress_forms_run_on_cpu(capsys):
    # the stress's other XC forms (unpolarized PBE, polarized PW92,
    # unpolarized VWN): off the card both sides are the CPU's, so every
    # term agrees exactly; on the card the gate is 1e-10 Ha/bohr^3
    assert chip_smoke.STRESS_FORM_TOL == 1e-10
    chip_smoke.check_stress_forms(torch.device("cpu"), "cpu")
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    forms = [r for r in recs if r.get("phase", "").startswith("stress_form_")]
    assert [r["phase"][12:] for r in forms] == list(chip_smoke.STRESS_FORMS)
    for rec in forms:
        assert max(rec["stress_card_vs_cpu"].values()) == 0.0
        assert np.shape(rec["stress"]) == (3, 3)
    # each form's kernel list names its own XC instantiation
    for name, (_, params, _, required) in chip_smoke.STRESS_FORMS.items():
        assert all(k in chip_smoke.SOURCE for k in required)


@pytest.mark.parametrize("name", ["so_nc", "so_us_sym"])
def test_spin_orbit_phases_run_on_cpu(name, capsys):
    # the spin-orbit decks from the tool's files through the parity phase:
    # the spinor path's kernels, moments held per component
    tool = reference_tool()
    assert set(chip_smoke.SO_DECK_PATH) == set(tool.FILE_DECKS)
    ctx = chip_smoke.deck_context(name, tool)
    assert ctx.cfg.parameters.so_correction
    assert ctx.unit_cell.atom_types[0].spin_orbit
    chip_smoke.parity_scf(ctx, torch.device("cpu"), reference(name), "cpu",
                          phase="parity_scf_" + name, deck=name,
                          required=chip_smoke.SO_DECK_PATH[name],
                          path="kset_nc")
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    moments = [r for r in recs if "max_moment_err" in r]
    assert len(moments) == 1
    assert moments[0]["compared"] == "components (spin-orbit)"
    assert moments[0]["max_moment_err"] <= chip_smoke.SO_MOMENT_TOL


def test_spin_orbit_supercell_takes_the_species():
    from sirius_tpu_torch.crystal.atom_type import AtomType
    from sirius_tpu_torch.testing import synthetic_silicon_species

    t = AtomType.from_dict("Si", synthetic_silicon_species(spin_orbit=True))
    ctx = chip_smoke.magnetic_supercell_context(
        1, SMALL, {"num_mag_dims": 3, "so_correction": True},
        chip_smoke.US_SYM, chip_smoke.CANTED[0], atom_type=t)
    assert ctx.unit_cell.atom_types[0] is t and ctx.num_mag_dims == 3
    assert ctx.beta.num_beta_total == 14
    rec = chip_smoke.spin_orbit_host_step(ctx, torch.device("cpu"), "cpu")
    assert rec["num_beta"] == 14
    assert rec["d_blocks_ms"] > 0 and rec["rotate_dm_ms"] > 0


@pytest.mark.parametrize("mixer", ["anderson_stable", "broyden2"])
def test_mixer_phases_run_on_cpu(mixer, capsys):
    tool = reference_tool()
    assert mixer + "_us_sym" in chip_smoke.MIXER_DECKS
    name = "small_us_sym_" + mixer
    ctx = chip_smoke.deck_context(name, tool)
    assert ctx.cfg.mixer.type == mixer
    chip_smoke.parity_scf(ctx, torch.device("cpu"), reference(name), "cpu",
                          phase="parity_scf_" + mixer, deck=name,
                          required=chip_smoke.US_KERNELS)
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rec["max_term_err"] <= 1e-8


def test_entry_point_phases_run_on_cpu(monkeypatch, capsys):
    # the CLI phase and the file route of full_width_us at the small shape,
    # the CLI's device taken from the deck as on the card but sent to the CPU
    from sirius_tpu_torch import cli
    from sirius_tpu_torch.dft.scf import run_scf

    monkeypatch.setattr(chip_smoke, "PARITY", SMALL)
    monkeypatch.setattr(cli, "deck_device", lambda path: "cpu")
    dev = torch.device("cpu")
    chip_smoke.entry_point_cli(dev, "cpu", reference("small_us_sym"))
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["phase"] == "entry_point_cli" and rec["test_passed"]
    assert rec["rc"] == 0 and rec["max_term_err"] <= 1e-8
    full = dict(SMALL, supercell=1)
    monkeypatch.setattr(chip_smoke, "FULL", full)
    monkeypatch.setitem(chip_smoke.FULL_ITERS, "full_width_us", 2)
    ctx = chip_smoke.make_context(full, {"num_dft_iter": 2,
                                         **chip_smoke.RUN_TO_END},
                                  chip_smoke.US_SYM)
    want = run_scf(ctx.cfg, ctx=ctx, device=dev)
    chip_smoke.full_width_us_from_file(dev, "cpu", want)
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["phase"] == "full_width_us_from_file"
    assert rec["bitwise_in_memory"] and rec["num_scf_iterations"] == 2


def test_fused_phases_run_on_cpu(monkeypatch, capsys):
    # K13, K14a, K14b and K15 against their plain versions and at their
    # edges; K14's wrappers launch on a card only, so off it they are
    # swapped for their plain versions (the checks then hold the plain
    # versions to themselves, as every other phase here does)
    from sirius_tpu_torch.kernels import mixer as k14

    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(k14, "mixer_gram", k14.mixer_gram_plain)
    monkeypatch.setattr(k14, "mixer_update", k14.mixer_update_plain)
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT)
    recs = chip_smoke.check_fused_kernels("small", ctx, torch.device("cpu"),
                                          "cpu")
    assert sorted(recs) == sorted(FUSED_CHECKED)
    for rec in recs.values():
        assert rec["max_rel_err"] <= rec["tol_rel"]
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                           "operations")
    assert recs["mixer.gram"]["library_ms"] is not None
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    edges = [r for r in lines if r.get("phase") == "kernel_edges"]
    fermi = {r["name"] for r in edges if r["name"].startswith("fermi.")}
    assert fermi == {f"fermi.{k}.{c}" for k in chip_smoke.SMEARINGS
                     for c in ("deck", "full", "degenerate")}
    mixer = [r for r in edges if r["name"] == "mixer"]
    assert {r["poison"] for r in mixer} == {"", "gram", "x_new"}
    assert {r["count"] for r in mixer} >= {0, 3, chip_smoke.MIXER_M, 64}
    assert all(r["fallback"] == r["fallback_plain"] for r in mixer)
    assert [r["fallback"] for r in mixer if r["poison"]] == [True, True]
    record = [r for r in edges if r["name"] == "scf_record"]
    assert record and record[0]["finite"] == 0.0


def test_fused_decks_are_the_reference_tools():
    # the records parity_fused_record reads: the JAX package's fused step,
    # one record an iteration; every deck that fuses launches K13, K14a,
    # K14b and K15, every path K13
    tool = reference_tool()
    for name in tool.FUSED_DECKS:
        ref = reference(name)
        assert ref["deck"]["control"]["device_scf"] == "auto"
        assert len(ref["scf_scalars"]) == ref["num_scf_iterations"]
        assert all(len(r) == 20 and r[15] == 1.0 for r in ref["scf_scalars"])
        assert chip_smoke.deck_context(
            name, tool).cfg.control.device_scf == "auto"
    for required in (chip_smoke.NC_FUSED, chip_smoke.US_FUSED,
                     chip_smoke.FP32_US_FUSED,
                     chip_smoke.XC_DECK_PATH["pbe_us_sym"][1],
                     chip_smoke.XC_DECK_PATH["pw_us_sym_afm"][1],
                     chip_smoke.FORCES_DECK_PATH["forces_us_sym_2atom"][1]):
        assert {"fermi", *chip_smoke.FUSED_STEP} <= set(required)
    for required in (chip_smoke.GAMMA_KERNELS, chip_smoke.SPINOR_KERNELS,
                     chip_smoke.CHUNKED_US_KERNELS,
                     chip_smoke.FP32_GAMMA_US_KERNELS):
        assert "fermi" in required and "scf_record" not in required


def test_density_hdiag_phases_run_on_cpu(monkeypatch, capsys):
    # K16a, K16b and K18 against their plain versions at a deck's shapes
    # and at their edges (off the card each wrapper is its plain version)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    recs = chip_smoke.check_density_hdiag_kernels("small_us_sym", ctx,
                                                  torch.device("cpu"), "cpu")
    assert sorted(recs) == sorted(SCATTER_CHECKED)
    for rec in recs.values():
        assert rec["bitwise"] and rec["max_rel_err"] == 0.0
        assert rec["bound_ms"] > 0 and rec["bound_by"] == "bytes"
    chip_smoke.check_density_hdiag_edges(torch.device("cpu"), "cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    edges = [r for r in lines if r.get("phase") == "density_hdiag_edges"][0]
    assert len(edges["bitwise"]) == 12 and all(edges["bitwise"].values())
    # every SCF path launches K16a, K16b and K18
    assert set(chip_smoke.EVERY_PATH) == set(SCATTER_CHECKED)


def test_potential_phases_run_on_cpu(monkeypatch, capsys):
    # K17a-K17d against their plain versions at a deck's shapes,
    # unpolarized and polarized, and at their edges (off the card each
    # wrapper is its plain version); each record names its source and the
    # JAX line it replaces
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    ctx = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    cpu = torch.device("cpu")
    recs = chip_smoke.check_potential_kernels("small_us_sym", ctx, cpu, "cpu",
                                              False, ".unpolarized")
    recs.update(chip_smoke.check_potential_kernels(
        "small_us_sym", ctx, cpu, "cpu", True))
    assert sorted(recs) == sorted(k for k in POTENTIAL_CHECKED
                                  if not k.endswith(".54"))
    for name, rec in recs.items():
        assert rec["bitwise"] and rec["max_rel_err"] == 0.0
        assert rec["bound_ms"] > 0 and rec["bound_by"] == "bytes"
        # one PyTorch call computes the unpolarized stack alone of these
        if name == "potential_passes.coarse_stack.unpolarized":
            assert rec["library_ms"] == 0.0
        else:
            assert rec["library_ms"] is None
        assert chip_smoke.SOURCE[name] == (
            "sirius_tpu_torch/csrc/potential_passes.cu")
        path, line = chip_smoke.REPLACES[name].split(":")
        assert os.path.exists(os.path.join(ROOT, path)) and int(line) > 0
    chip_smoke.check_potential_edges(cpu, "cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    edges = [r for r in lines if r.get("phase") == "potential_edges"][0]
    assert len(edges["bitwise"]) == 28 and all(edges["bitwise"].values())
    assert all(chip_smoke.read_launches()[k] == 0 for k in K17)


def test_potential_kernels_are_required_on_every_collinear_path():
    # every collinear SCF path launches K17a, K17b, K17c (i) and K17d; a
    # polarized GGA or SCAN deck K17c (ii) too; the spinor path K17c (i)
    # and K17d's fill
    cs = chip_smoke
    unpolarized = tuple(k for k in K17 if k != GGA_INPUTS)
    collinear = [cs.NC_KERNELS, cs.US_KERNELS, cs.NC_FUSED, cs.US_FUSED,
                 cs.GAMMA_KERNELS, cs.GAMMA_US_KERNELS, cs.CHUNKED_US_KERNELS,
                 cs.FULL_SCAN_KERNELS, cs.FULL_GAMMA_PBE_FM_KERNELS,
                 cs.FP32_US_KERNELS, cs.FP32_US_FUSED,
                 cs.FP32_GAMMA_US_KERNELS, cs.FP32_CHUNKED_US_KERNELS,
                 cs.FP32_SCAN_KERNELS]
    collinear += [req for _, req in cs.SINGLE_K_PATH.values()]
    collinear += [req for _, req in cs.XC_DECK_PATH.values()]
    collinear += [req for _, req, _ in cs.FORCES_DECK_PATH.values()]
    collinear += [req for path, req in cs.FP32_DECK_PATH.values()
                  if path != "kset_nc"]
    for required in collinear:
        assert set(unpolarized) <= set(required), required
    polarized_gga = [cs.XC_DECK_PATH["gamma_pbe_us_sym_fm"][1],
                     cs.XC_DECK_PATH["scan_us_sym_fm"][1],
                     cs.FULL_GAMMA_PBE_FM_KERNELS,
                     cs.FORCES_DECK_PATH["forces_gamma_pbe_fm"][1]]
    for required in polarized_gga:
        assert GGA_INPUTS in required
    for deck in ("pbe_us_sym", "gamma_nc_pbesol", "scan_us_sym",
                 "pw_us_sym_afm"):
        assert GGA_INPUTS not in cs.XC_DECK_PATH[deck][1], deck
    # polarized, not the symmetry of axial fields, asks for K17c (ii)
    assert GGA_INPUTS in cs.xc_kernels(cs.US_KERNELS, True, False,
                                       polarized=True)
    assert GGA_INPUTS not in cs.xc_kernels(cs.US_KERNELS, True, True)
    spinor = [cs.SPINOR_KERNELS, cs.SPINOR_SYM_KERNELS,
              cs.FP32_SPINOR_SYM_KERNELS, cs.FP32_DECK_PATH[
                  "small_spinor_pbe_us_sym_fp32"][1]]
    spinor += list(cs.SPINOR_DECK_PATH.values()) + list(
        cs.SO_DECK_PATH.values())
    nc = {"potential_passes.hartree_veff", "potential_passes.coarse_fill"}
    for required in spinor:
        assert nc <= set(required), required
        assert not set(required) & (set(K17) - nc), required
    # on the card a K17 pass that never launched fails the phase
    cuda = torch.device("cuda")
    launches = {name: 1 for name in cs.SOURCE}
    for name in unpolarized:
        launches[name] = 0
        with pytest.raises(AssertionError, match=name):
            cs.check_launched("kset", cuda, launches, cs.US_KERNELS)
        launches[name] = 1
    launches[GGA_INPUTS] = 0
    with pytest.raises(AssertionError, match=GGA_INPUTS):
        cs.check_launched("gamma_fm", cuda, launches,
                          cs.FULL_GAMMA_PBE_FM_KERNELS)


def test_checkpoint_and_recovery_phases_run_on_cpu(capsys):
    from sirius_tpu_torch.dft.scf import run_scf

    dev = torch.device("cpu")
    ctx = chip_smoke.make_context(SMALL, {
        "num_dft_iter": chip_smoke.FULL_ITERS["full_width_us"],
        **chip_smoke.RUN_TO_END}, chip_smoke.US_SYM)
    want = run_scf(ctx.cfg, ctx=ctx, device=dev)
    rec = chip_smoke.checkpoint_resume(ctx, dev, "cpu", want, spec=SMALL,
                                       deck_name="small_us_sym")
    assert rec["killed"] and rec["file_bytes"] > 0 and rec["sirius_h5_loads"]
    assert rec["num_scf_iterations"] == want["num_scf_iterations"]
    assert len(rec["fetch_state_history_seconds"]) == 1
    ctx2 = chip_smoke.make_context(SMALL, chip_smoke.TIGHT, chip_smoke.US_SYM)
    rec = chip_smoke.recovery_fused(ctx2, dev, "cpu")
    assert rec["snapshots"] >= 2
    assert [a for _, a, _, _ in rec["runs"]["nan4_7_10"]["ladder"]] == [
        "flush_history", "halve_beta_linear", "disable_device_scf"]
    assert rec["runs"]["oom2"]["ladder"][0][:2] == ("device_oom",
                                                    "disable_device_scf")
