"""What the sweep kernels compiled to: a census of the SASS of the built
kernel library (csrc/*.cu), per kernel.

    python3 -m hagrid_tpu_torch.exp.sass [--out PATH] [--all]

Runs `cuobjdump -sass` on the library that `ops/_build.py` builds (and
builds it first if needed), and prints for each sweep instance (`--all`:
every kernel) its instruction count and the opcodes that say where a
per-pair cost comes from: the reciprocal and its slow path (MUFU.RCP,
CALL), float <-> int conversions (F2I, I2F), spills (LDL, STL), barriers
(BAR, SYNCS: mbarrier waits), bulk copies (UBLKCP), shared loads (LDS)
and the FP32 instructions. PATH receives the whole disassembly. Needs
the CUDA toolkit (cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

from ..ops import _build

# Opcode prefixes counted (a prefix counts every modifier: FSETP.GE.AND ...).
WATCH = ("MUFU.RCP", "CALL", "RET", "F2I", "I2F", "LDL", "STL", "BAR",
         "SYNCS", "UBLKCP", "LDS", "LDG", "STG", "FADD", "FMUL", "FFMA",
         "FSETP", "FSEL", "FMNMX", "LOP3", "BRA", "ATOMG", "RED")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _tool(name):
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", name)
    return cand if os.path.exists(cand) else shutil.which(name)


def disassemble(lib_path=None) -> str:
    tool = _tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found (set CUDA_HOME)")
    lib_path = lib_path or str(_build.build())
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def demangle(names):
    tool = _tool("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def census(sass: str) -> dict:
    """{kernel name: Counter of opcodes (full) and '_total'}."""
    per = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = per.setdefault(m.group(1), collections.Counter())
            continue
        if cur is None:
            continue
        m = _INSN.search(line)
        if m and m.group(1) != "NOP":
            cur[m.group(1)] += 1
            cur["_total"] += 1
    return per


def summary(counts: collections.Counter) -> dict:
    out = {"instructions": counts["_total"]}
    for w in WATCH:
        n = sum(c for op, c in counts.items()
                if op == w or op.startswith(w + "."))
        if n:
            out[w] = n
    return out


def run(lib_path=None, out=None, every=False) -> dict:
    sass = disassemble(lib_path)
    if out:
        with open(out, "w") as f:
            f.write(sass)
    per = census(sass)
    names = demangle(list(per))
    return {names[k]: summary(c) for k, c in per.items()
            if every or "sweep" in names[k]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the whole disassembly here")
    ap.add_argument("--all", action="store_true", help="every kernel")
    a = ap.parse_args(argv)
    for name, s in run(out=a.out, every=a.all).items():
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in s.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
