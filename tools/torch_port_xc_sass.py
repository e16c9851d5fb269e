"""Registers, spills, occupancy and the static fp64 instruction count of the
XC kernels, read from what nvcc compiles for the H100.

For each checkout (this one, and --tree DIR for another, e.g. the parent
unpacked into a git-ignored directory) it compiles csrc/lda_xc.cu,
csrc/gga_xc.cu and csrc/mgga_xc.cu with the port's nvcc flags plus
-Xptxas -v, and reads:

- per kernel function, ptxas's registers, stack frame and spill bytes, and
  the theoretical occupancy they allow at the wrappers' 128 threads a
  block (65,536 registers an SM, allocated 8 a thread; 64 warps an SM);
- from `cuobjdump -sass`, the kernel's instructions, and its fp64 ones:
  the D* opcodes (DFMA, DMUL, DADD, DSETP, DMNMX, DSET), the 64-bit MUFU
  seeds (RCP64H, RSQ64H) and the conversions to or from fp64. The count is
  static: every instruction of the kernel's code once, the branches not
  taken and the math library's slow paths included, and a subroutine the
  code calls from several places (pow, division's slow path) once; and
  call-weighted: each subroutine's count added at each CALL site again
  (recursively), so pow called sixteen times counts sixteen times. Neither
  is the executed count of a point (branches not taken count, loops
  once), but the call-weighted one compares code that inlines its math
  with code that calls it;
- the time that count takes over N points at the card's fp64 issue rate
  (SMs x 64 fp64 lanes x the maximum SM clock, from nvidia-smi), beside
  the kernel's records in chip_smoke.py;
- a hash of the SASS without addresses, so two checkouts that compile a
  kernel to the same code show the same hash.

Each instantiation of a templated kernel (K7b's lda_set_polarized<Set>,
K7g's gga_xc_polarized<kSet>, ...) is a function of its own, counted
apart.

One JSON line a checkout and kernel function, then the card's name and
power limit.

    python3 tools/torch_port_xc_sass.py [--tree DIR] [--out FILE] [--dump DIR]
                                        [--source NAME ...]
    python3 tools/torch_port_xc_sass.py --sass-dir DIR --rate R

--source NAME reads csrc/NAME.cu in place of the three XC sources (e.g.
`--source augmentation` for K4 and K5; the issue times per point are then
not the kernel's).

--dump writes each library's `cuobjdump -sass` text into DIR; --sass-dir
reads such a directory back instead of compiling (no toolkit or card), the
issue times at R fp64 instructions a second (a record's fp64_issue_rate).

Needs nvcc and cuobjdump (the CUDA toolkit) and a CUDA card for the rate.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("lda_xc", "gga_xc", "mgga_xc")
FP64_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET")
FP64_MUFU = ("MUFU.RCP64H", "MUFU.RSQ64H")
POINTS = {"50^3": 50**3, "96^3": 96**3, "144^3": 144**3}
THREADS = 128


def is_fp64(op: str) -> bool:
    base = op.split(".")[0]
    if base in FP64_OPS:
        return True
    if any(op.startswith(m) for m in FP64_MUFU):
        return True
    return base in ("F2F", "I2F", "F2I") and "F64" in op


def ptxas_info(log: str) -> dict:
    """{mangled function: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from nvcc -Xptxas -v output."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def sass_functions(text: str) -> dict:
    """{mangled function: {"ops", "text", "addr"}}: each instruction's
    opcode, address-free text and address."""
    funcs: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"ops": [], "text": [], "addr": []}
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and m:
            ins = m.group(2).strip()
            toks = ins.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                funcs[name]["ops"].append(toks[0])
                funcs[name]["text"].append(ins)
                funcs[name]["addr"].append(int(m.group(1), 16))
    return funcs


def call_weighted_fp64(fn: dict) -> int:
    """The fp64 count with each called subroutine (from its CALL target to
    its first RET) counted again at every CALL site, recursively; the
    subroutines' own code is not counted where it lies."""
    ops, text = fn["ops"], fn["text"]
    where = {a: i for i, a in enumerate(fn["addr"])}

    def target(i):
        m = re.search(r"CALL\S*\s+(0x[0-9a-f]+)", text[i])
        return int(m.group(1), 16) if m else None

    subs = {}
    for i, op in enumerate(ops):
        t = target(i) if op.startswith("CALL") else None
        if t in where and t not in subs:
            j = where[t]
            while j < len(ops) and not ops[j].startswith("RET"):
                j += 1
            subs[t] = range(where[t], j + 1)
    inside = {j for r in subs.values() for j in r}
    memo: dict = {}

    def weight(indices, seen=()) -> int:
        total = 0
        for j in indices:
            total += is_fp64(ops[j])
            t = target(j) if ops[j].startswith("CALL") else None
            if t in subs and t not in seen:
                if t not in memo:
                    memo[t] = weight(subs[t], seen + (t,))
                total += memo[t]
        return total

    return weight(j for j in range(len(ops)) if j not in inside)


def occupancy(registers: int) -> float:
    per_thread = -(-registers // 8) * 8
    warps = min(64, 65536 // (per_thread * 32))
    warps -= warps % (THREADS // 32)
    return warps / 64.0


def demangle(names) -> dict:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def issue_rate() -> tuple[float, str]:
    """fp64 thread-instructions a second: SMs x 64 lanes x max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    return sms * 64 * mhz * 1e6, f"{sms} SMs x 64 x {mhz:.0f} MHz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout's root")
    ap.add_argument("--out", default="", help="also write the lines here")
    ap.add_argument("--dump", default="", help="write the SASS text here")
    ap.add_argument("--sass-dir", default="",
                    help="read dumped SASS from here instead of compiling")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="fp64 instructions a second, with --sass-dir")
    ap.add_argument("--source", action="append", default=[],
                    help="a csrc/ source to read in place of the XC ones")
    args = ap.parse_args(argv)
    if args.sass_dir:
        for path in sorted(os.listdir(args.sass_dir)):
            with open(os.path.join(args.sass_dir, path)) as f:
                sass = sass_functions(f.read())
            for fn in sorted(sass):
                static = sum(1 for op in sass[fn]["ops"] if is_fp64(op))
                weighted = call_weighted_fp64(sass[fn])
                print(json.dumps({
                    "file": path, "function": fn,
                    "instructions": len(sass[fn]["ops"]),
                    "fp64_instructions": static,
                    "fp64_call_weighted": weighted,
                    "fp64_issue_ms": {box: static * n / args.rate * 1e3
                                      for box, n in POINTS.items()}
                    if args.rate else None,
                    "fp64_call_weighted_issue_ms": {
                        box: weighted * n / args.rate * 1e3
                        for box, n in POINTS.items()} if args.rate else None}),
                    flush=True)
        return 0
    sys.path.insert(0, ROOT)
    from sirius_tpu_torch.kernels import build

    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    rate, rate_note = issue_rate()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for tree in [ROOT] + [os.path.abspath(t) for t in args.tree]:
            csrc = os.path.join(tree, "sirius_tpu_torch", "csrc")
            paths = {src: os.path.join(csrc, f"{src}.cu")
                     for src in args.source or SOURCES}
            for src, path in paths.items():
                lib = os.path.join(tmp, f"{abs(hash(tree))}-{src}.so")
                proc = subprocess.run(
                    [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                     path], capture_output=True, text=True)
                if proc.returncode != 0:
                    print(proc.stdout + proc.stderr, file=sys.stderr)
                    return proc.returncode
                info = ptxas_info(proc.stdout + proc.stderr)
                text = subprocess.run(
                    [cuobjdump, "-sass", lib], check=True, capture_output=True,
                    text=True).stdout
                if args.dump:
                    os.makedirs(args.dump, exist_ok=True)
                    tag = "this" if tree == ROOT else os.path.basename(tree)
                    with open(os.path.join(args.dump, f"{tag}-{src}.sass"),
                              "w") as f:
                        f.write(text)
                sass = sass_functions(text)
                names = demangle(sorted(sass))
                for fn in sorted(sass):
                    ops = sass[fn]["ops"]
                    fp64 = sum(1 for op in ops if is_fp64(op))
                    weighted = call_weighted_fp64(sass[fn])
                    res = info.get(fn, {})
                    rec = {"tree": tree, "source": src, "function": fn,
                           "demangled": names[fn],
                           "instructions": len(ops), "fp64_instructions": fp64,
                           "fp64_call_weighted": weighted,
                           "fp64_by_op": {},
                           "sass_sha256": hashlib.sha256(
                               "\n".join(sass[fn]["text"]).encode()
                           ).hexdigest()[:16],
                           **res, "fp64_issue_rate": rate,
                           "fp64_issue_rate_from": rate_note,
                           "nvidia_smi": smi}
                    for op in ops:
                        if is_fp64(op):
                            key = op.split(".")[0]
                            rec["fp64_by_op"][key] = rec["fp64_by_op"].get(
                                key, 0) + 1
                    if "registers" in res:
                        rec["occupancy"] = occupancy(res["registers"])
                    rec["fp64_issue_ms"] = {
                        box: fp64 * n / rate * 1e3 for box, n in POINTS.items()}
                    rec["fp64_call_weighted_issue_ms"] = {
                        box: weighted * n / rate * 1e3
                        for box, n in POINTS.items()}
                    lines.append(json.dumps(rec))
                    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
