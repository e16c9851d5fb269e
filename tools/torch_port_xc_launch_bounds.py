"""The compiled K7g / K7s sets (PBE, SCAN) under __launch_bounds__(128, K)
for a few K: registers and spills (ptxas), event and device time on
chip_smoke.py's 54-atom XC field (144^3) and the error against the plain
version, one JSON line a variant and mode. Each variant is the checkout's
csrc/gga_xc.cu or mgga_xc.cu with the compiled set's kernels held to K
blocks of 128 an SM (the source's own bound replaced where it has one),
built by nvcc into a temporary directory and swapped into the wrapper's
library slot; K = 0 is the source as it stands.

    python3 tools/torch_port_xc_launch_bounds.py

Run from the repository root; needs nvcc and a CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

# (min blocks polarized, unpolarized) a variant; 0 leaves the source's
VARIANTS = {"gga_xc": [(0, 0), (5, 8), (6, 10)],
            "mgga_xc": [(0, 0), (4, 5), (5, 6), (6, 7)]}
SETS = {"gga_xc": ("kSet", "kPbe", "gga_xc.pbe"),
        "mgga_xc": ("kKind", "kScanSet", "mgga_xc.scan")}


def bounded(text: str, kern: str, par: str, one: str, k: int) -> str:
    """The source with kernel template `kern` held to k blocks for the
    compiled set (parameter `par` equal to `one`)."""
    bound = f"__launch_bounds__(128, ({par} == {one} ? {k} : 1))"
    pat = re.compile(r"__global__ void (__launch_bounds__\([^()]*\)\s*)?"
                     + kern + r"\(")
    out, n = pat.subn(f"__global__ void {bound} {kern}(", text)
    if n != 1:
        raise RuntimeError(f"{kern}: {n} matches")
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        print("torch_port_xc_launch_bounds: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sirius_tpu_torch.kernels import build
    from sirius_tpu_torch.kernels import gga_xc as k7g
    from sirius_tpu_torch.kernels import mgga_xc as k7s

    spec = importlib.util.spec_from_file_location(
        "sass", os.path.join("tools", "torch_port_xc_sass.py"))
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    # the inputs chip_smoke.check_kernels_xc builds at the 54-atom fine box
    fields = {}
    record = cs.record_kernel

    def grab(out, deck, gpu, name, kout, pout, fn_k, fn_p, *a, **kw):
        fields[name] = getattr(fn_k, "args", ())[:-1]
        out[name] = {}

    cs.record_kernel = grab
    try:
        ctx = cs.make_context(cs.GAMMA54, {"num_dft_iter": 4,
                                           **cs.RUN_TO_END}, cs.US_SYM)
        cs.check_kernels_xc("si54", ctx, dev, "x")
    finally:
        cs.record_kernel = record
    kernels = {("gga_xc", True): (k7g.gga_xc, k7g.gga_xc_plain),
               ("gga_xc", False): (k7g.gga_xc_unpolarized,
                                   k7g.gga_xc_unpolarized_plain),
               ("mgga_xc", True): (k7s.mgga_xc, k7s.mgga_xc_plain),
               ("mgga_xc", False): (k7s.mgga_xc_unpolarized,
                                    k7s.mgga_xc_unpolarized_plain)}
    tmp = tempfile.mkdtemp()
    for src, variants in VARIANTS.items():
        text = open(os.path.join("sirius_tpu_torch", "csrc",
                                 f"{src}.cu")).read()
        par, one, name = SETS[src]
        names = cs.PBE if src == "gga_xc" else cs.SCAN
        for kp, ku in variants:
            s = text
            for kern, k in ((f"{src}_polarized", kp),
                            (f"{src}_unpolarized", ku)):
                if k:
                    s = bounded(s, kern, par, one, k)
            path = os.path.join(tmp, f"{src}_{kp}_{ku}.cu")
            with open(path, "w") as f:
                f.write(s)
            lib = path[:-3] + ".so"
            proc = subprocess.run(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                 os.path.abspath(os.path.join("sirius_tpu_torch", "csrc")),
                 "-o", lib, path], capture_output=True, text=True)
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            info = {("unpolarized" if "unpolarized" in fn else "polarized"):
                    v for fn, v in sass.ptxas_info(
                        proc.stdout + proc.stderr).items() if "ILi1E" in fn}
            variant = ctypes.CDLL(lib)
            fn = getattr(variant, src)
            fn.argtypes = list(build.SIGNATURES[src][src])
            fn.restype = ctypes.c_int
            for pol in (True, False):
                kern, plain = kernels[(src, pol)]
                args = fields[name + ("" if pol else ".unpolarized")]
                want = plain(*args, names)
                own = build.library(src)
                build._LOADED[src] = variant
                try:
                    call = functools.partial(kern, *args, names)
                    got = call()
                    rel = max(cs.rel_err(a, b)[1] for a, b in zip(got, want))
                    rec = {"source": src, "polarized": pol,
                           "min_blocks": kp if pol else ku, "ptxas": info,
                           "ms": cs.time_ms(call),
                           "device_ms": cs.device_ms(call, dev, (
                               src + ("_polarized" if pol
                                      else "_unpolarized"),)),
                           "max_rel_err": rel, "nvidia_smi": smi}
                finally:
                    build._LOADED[src] = own
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
