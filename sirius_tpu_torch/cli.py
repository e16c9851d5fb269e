"""sirius-scf-torch: the sirius.scf mini-app on the port (reference
apps/mini_app/sirius.scf.cpp; the JAX package's sirius_tpu/cli.py).

    sirius-scf-torch [sirius.json] [--test_against output_ref.json]
                     [--task ground_state_new] [--device cuda|cpu] [-v]

The same positional input, --test_against, --task choices and -v as
sirius-scf. --device takes the place of --platform: without it a deck
whose control.processing_unit is "cpu" runs on the CPU (every kernel's
plain PyTorch version), any other on the GPU, which must be there. Exit
codes: 0 done (and TEST PASSED), 1 TEST FAILED, 2 a missing input file or
a task the port does not run yet (the message names its ROADMAP item).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

TASKS = ["ground_state_new", "ground_state_restart", "ground_state_relax",
         "ground_state_direct", "k_point_path", "eos", "molecular_dynamics"]


def deck_device(path: str) -> str:
    """"cpu" for a deck with control.processing_unit "cpu", else "cuda"."""
    try:
        with open(path) as f:
            unit = json.load(f).get("control", {}).get("processing_unit")
    except (OSError, json.JSONDecodeError):
        unit = None
    return "cpu" if unit == "cpu" else "cuda"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="sirius-scf-torch",
        description="Kohn-Sham DFT SCF mini-app on the PyTorch/CUDA port",
    )
    p.add_argument("input", nargs="?", default="sirius.json",
                   help="JSON input file")
    p.add_argument("--test_against",
                   help="reference output JSON to compare against")
    p.add_argument("--task", default="ground_state_new", choices=TASKS,
                   help="calculation task (reference sirius.scf task "
                        "semantics)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where to run; default: cpu when the deck requests "
                        "processing_unit=cpu, else cuda")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="raise log level (-v info, -vv debug)")
    args = p.parse_args(argv)
    logging.basicConfig(level=(logging.WARNING, logging.INFO,
                               logging.DEBUG)[min(args.verbose, 2)])
    # fail fast on a bad input path, before torch and the context load
    if not os.path.isfile(args.input):
        print(f"sirius-scf-torch: input file not found: {args.input}",
              file=sys.stderr)
        return 2
    from sirius_tpu_torch.dft.scf import run_scf_from_file

    device = args.device or deck_device(args.input)
    try:
        return run_scf_from_file(args.input, test_against=args.test_against,
                                 task=args.task, device=device)
    except NotImplementedError as e:
        print(f"sirius-scf-torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
