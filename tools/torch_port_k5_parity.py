"""How the parity decks of chip_smoke.py move with K5's summation order.

K5 (kernels/augmentation.py::d_operator) sums each D entry in an order set
by its launch plan: the G tile and the blocks an SM fix the chunks of the
split-K sum. Any order is right to ~1e-16 relative, but an SCF stopped at
a tolerance amplifies such differences, and on the card a deck run to
TIGHT can land ~1e-8 Ha from its record by rounding alone. This tool
measures that on the card:

- default: every 2-atom parity deck of chip_smoke.py that launches K5,
  once per plan given as TILE/BLOCKS_PER_SM, with chip_smoke.py's own
  gates; one JSON line a plan with each deck's iteration count, its
  largest energy-term gap to its record, and the gates it failed
  (reported, not raised);
- --past-stop: the TIGHT-stopped ultrasoft decks full_width_2atom_us_sym
  and gamma_us_sym at fixed iteration counts past their stop, with the
  current plan, each against its TIGHT record, and gamma_us_sym also
  against the JAX package's record of the same deck at a fixed 16
  iterations (gamma_us_sym_fixed16).

    python3 tools/torch_port_k5_parity.py [--plans 32/3 64/3 64/2 32/2]
        [--past-stop]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forced_plan(k45, tg: int, bps: int):
    """d_operator_plan with the G tile and the blocks an SM fixed."""
    base_plan = k45.d_operator_plan

    def plan(na, nqlm, nch, ng, sm_count):
        base = base_plan(na, nqlm, nch, ng, sm_count)
        group = k45._largest_group(na, nqlm, nch, tg)
        chunk = -(-(-(-ng // tg)) // (sm_count * bps)) * tg
        return dict(base, tg=tg, group=group, ngroups=-(-na // group),
                    chunk=chunk, nblocks=-(-ng // chunk))

    return plan


def k5_decks(cs, dev, refs, gpu):
    """(name, run) of chip_smoke.py's 2-atom parity decks that launch K5."""
    tool = cs.reference_tool()
    decks = [("full_width_2atom_us_sym", lambda: cs.parity_scf(
        cs.make_context(cs.PARITY, cs.TIGHT, cs.US_SYM), dev,
        refs["full_width_2atom_us_sym"], gpu, phase="parity_scf_us",
        deck="full_width_2atom_us_sym", required=cs.US_KERNELS))]
    for name in ("gamma_us_sym", "chunked_us_sym"):
        path, required = cs.SINGLE_K_PATH[name]
        decks.append((name, lambda name=name, path=path, required=required:
                      cs.parity_scf(cs.single_k_context(name), dev, refs[name],
                                    gpu, deck=name, required=required,
                                    path=path)))
    for name, (path, required) in cs.XC_DECK_PATH.items():
        if "_us" in name:
            decks.append((name, lambda name=name, path=path, required=required:
                          cs.parity_scf(cs.xc_context(name), dev, refs[name],
                                        gpu, deck=name, required=required,
                                        path=path)))
    for name in tool.SPINOR_DECKS:
        decks.append((name, lambda name=name: cs.parity_scf(
            cs.deck_context(name, tool), dev, refs[name], gpu, deck=name,
            required=cs.SPINOR_DECK_PATH[name], path="kset_nc")))
    for name in cs.FP32_DECK_PATH:
        decks.append((name, lambda name=name: cs.parity_scf_fp32(
            cs.deck_context(name, tool), dev, refs, name, gpu)))
    return decks


def run_plans(cs, k45, dev, refs, gpu, plans) -> None:
    decks = k5_decks(cs, dev, refs, gpu)
    base_plan = k45.d_operator_plan
    for label in plans:
        tg, bps = (int(x) for x in label.split("/"))
        k45.d_operator_plan = forced_plan(k45, tg, bps)
        gaps, failed = {}, {}
        for name, run in decks:
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    run()
            except AssertionError as e:
                failed[name] = str(e)[:300]
            for line in out.getvalue().splitlines():
                rec = json.loads(line)
                if "max_term_err" in rec:
                    gaps[name] = [rec["num_scf_iterations"],
                                  rec["max_term_err"]]
        print(json.dumps({"plan": label, "gpu": gpu, "decks": gaps,
                          "failed": failed}), flush=True)
    k45.d_operator_plan = base_plan


def past_stop(cs, dev, refs, gpu) -> None:
    from sirius_tpu_torch.dft.scf import run_scf

    for deck, spec, counts in (
            ("full_width_2atom_us_sym", cs.PARITY, (None, 11, 13, 16, 20)),
            ("gamma_us_sym", cs.GAMMA2, (None, 9, 12, 16))):
        for n in counts:
            extra = (cs.TIGHT if n is None
                     else {"num_dft_iter": n, **cs.RUN_TO_END})
            ctx = cs.make_context(spec, extra, cs.US_SYM)
            res = run_scf(ctx.cfg, ctx=ctx, device=dev)
            rec = {"deck": deck, "gpu": gpu, "fixed_iterations": n,
                   "num_scf_iterations": res["num_scf_iterations"],
                   "rms_history": res["rms_history"]}
            for ref in (deck, deck + "_fixed16"):
                if ref in refs:
                    gap = max(abs(res["energy"][k] - v)
                              for k, v in refs[ref]["energy"].items())
                    rec[f"max_term_gap_to_{ref}"] = gap
            print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", nargs="+", default=["32/3", "64/3", "64/2",
                                                   "32/2"],
                    help="K5 plans as G_TILE/BLOCKS_PER_SM")
    ap.add_argument("--past-stop", action="store_true",
                    help="run the TIGHT decks past their stop instead")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_k5_parity: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = f"{torch.cuda.get_device_name(0)} ({cs.nvidia_smi()})"
    build.build_all()
    with open(os.path.join(ROOT, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    if args.past_stop:
        past_stop(cs, dev, refs, gpu)
    else:
        run_plans(cs, k45, dev, refs, gpu, args.plans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
