"""A non-collinear parity deck (default spinor_pbe_us_sym) from its start
and from starts perturbed by a relative 1e-13 (seeds 1-3), on the card,
with the checkout in the working directory: each run's total moment and
the gate's moment error (chip_smoke.py::parity_scf), one JSON line a run.
The deck is non-magnetic at its shape, so its residual moment is set by
rounding; the spread of these runs says how far one run can be trusted.

    python3 tools/torch_port_spinor_spread.py [DECK]
    (cd OTHER_CHECKOUT && python3 /path/to/torch_port_spinor_spread.py)

Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    deck = argv[0] if argv else "spinor_pbe_us_sym"
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_spinor_spread: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import sirius_tpu_torch.dft.scf_nc as scf_nc
    from sirius_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    gpu = torch.cuda.get_device_name(0)
    with open(os.path.join("sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    tool = cs.reference_tool()
    start = scf_nc._initial_spinors
    for seed in (None, 1, 2, 3):
        if seed is None:
            scf_nc._initial_spinors = start
        else:
            rng = np.random.default_rng(seed)

            def perturbed(ctx, rng=rng):
                psi = start(ctx)
                return psi * (1.0 + 1e-13 * rng.standard_normal(psi.shape))

            scf_nc._initial_spinors = perturbed
        buf = io.StringIO()
        err = None
        with contextlib.redirect_stdout(buf):
            try:
                cs.parity_scf(cs.deck_context(deck, tool), dev, refs[deck],
                              gpu, phase="spread", deck=deck,
                              required=cs.SPINOR_DECK_PATH[deck],
                              path="kset_nc")
            except AssertionError as e:  # a gate's failure is the result
                err = str(e)
        recs = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        mom = [r for r in recs if "max_moment_err" in r][-1]
        print(json.dumps({"tree": os.getcwd(), "deck": deck, "seed": seed,
                          "total_moment": mom["total_moment"],
                          "max_moment_err": mom["max_moment_err"],
                          "gate_failed": err,
                          "nvidia_smi": cs.nvidia_smi()}), flush=True)
    scf_nc._initial_spinors = start
    return 0


if __name__ == "__main__":
    sys.exit(main())
