"""The port and chip_smoke.py import neither JAX nor the JAX package, nor
h5py (absent where the port runs; io/h5.py reads and writes the
checkpoint's HDF5): in a fresh interpreter, import every module of
sirius_tpu_torch and chip_smoke, then none of jax, sirius_tpu and h5py
may be in sys.modules."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import sirius_tpu_torch
mods = ["sirius_tpu_torch"]
for m in pkgutil.walk_packages(sirius_tpu_torch.__path__, "sirius_tpu_torch."):
    mods.append(m.name)
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "sirius_tpu"
             or m.startswith("sirius_tpu.") or m == "h5py"
             or m.startswith("h5py."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "sirius_tpu_torch.dft.scf" in res["modules"]
    assert "sirius_tpu_torch.kernels.local_hpsi" in res["modules"]
    assert "sirius_tpu_torch.ops.augmentation" in res["modules"]
    assert "sirius_tpu_torch.ops.hubbard" in res["modules"]
    for name in ("ops.gamma", "ops.beta_chunked", "kernels.gamma_pack",
                 "kernels.beta_chunk", "kernels.gga_xc",
                 "kernels.xc_gradient", "kernels.xc_functionals",
                 "kernels.mgga_xc", "kernels.mgga_tau", "ops.mgga",
                 "ops.spinor", "parallel.batched_nc", "dft.potential_nc",
                 "dft.scf_nc", "kernels.spinor_veff",
                 "kernels.density_accumulate_nc", "io.upf", "ops.so",
                 "cli", "io.h5", "io.checkpoint", "dft.recovery",
                 "obs.forecast", "utils.faults", "utils.devfail",
                 "utils.profiler", "utils.checksums",
                 "kernels.density_scatter", "kernels.h_diag"):
        assert "sirius_tpu_torch." + name in res["modules"]
    assert len(res["modules"]) >= 30
