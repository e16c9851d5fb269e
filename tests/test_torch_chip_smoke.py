"""chip_smoke.py off the card: without CUDA it exits non-zero and prints no
result, and its kernel and parity phases run end to end on the CPU at the
small decks, norm-conserving and ultrasoft + symmetry (every wrapper then
takes its plain version, so the checks compare the plain versions with
themselves and no launch is counted)."""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402

SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
# the kernels check_kernels_us holds against their plain versions
US_CHECKED = ("veff_multiply", "augmentation.rho_aug",
              "augmentation.d_operator", "symmetrize_pw")


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
    assert sorted(recs) == sorted(set(chip_smoke.SOURCE) - set(US_CHECKED))
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
