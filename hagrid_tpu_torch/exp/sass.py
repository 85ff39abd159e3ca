"""What the sweep kernels compiled to: a census of the SASS of the built
kernel library (csrc/*.cu), per kernel.

    python3 -m hagrid_tpu_torch.exp.sass [--out PATH] [--all]

Runs `cuobjdump -sass` on the library that `ops/_build.py` builds (and
builds it first if needed), and prints for each sweep instance and each
dots instance (K5, K6/K7; `--all`: every kernel) its instruction count
and the opcodes that say where a per-pair cost comes from: the
reciprocal and its slow path (MUFU.RCP, CALL), float <-> int conversions
(F2I, I2F), spills (LDL, STL), barriers (BAR, SYNCS: mbarrier waits),
bulk copies (UBLKCP), shared loads (LDS), the FP32 instructions, and for
K6/K7 the warpgroup products (HGMMA, WARPGROUP: their fences and waits),
the bf16 conversions (F2FP) and shuffles (SHFL). `inner_loop` counts
the same opcodes in a kernel's innermost loop that holds its FP32 work
(K5: one row of 6 refs x 8 rays a thread), so that a count divided by the
loop's pairs is a cost per pair. PATH receives the whole disassembly.
Needs the CUDA toolkit (cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import os
import re
import shutil
import subprocess

from ..ops import _build

# Opcode prefixes counted (a prefix counts every modifier: FSETP.GE.AND ...).
WATCH = ("MUFU.RCP", "CALL", "RET", "F2I", "I2F", "LDL", "STL", "BAR",
         "SYNCS", "UBLKCP", "LDS", "LDG", "STG", "FADD", "FMUL", "FFMA",
         "FSETP", "FSEL", "FMNMX", "LOP3", "BRA", "ATOMG", "RED", "HGMMA",
         "WARPGROUP", "F2FP", "SHFL")
# Kernels the census covers without --all.
SELECT = ("sweep", "dots_fp32", "dots_bf16")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*)")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")
_FP32 = ("FFMA", "FMUL", "FADD")


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


def instructions(sass: str) -> dict:
    """{kernel name: [(address, opcode, operands)]}, NOPs left out."""
    per = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = per.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _INSN.search(line)
        if m and m.group(2) != "NOP":
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return per


def _count(insns) -> collections.Counter:
    c = collections.Counter(op for _, op, _ in insns)
    c["_total"] = len(insns)
    return c


def census(sass: str) -> dict:
    """{kernel name: Counter of opcodes (full) and '_total'}."""
    return {k: _count(v) for k, v in instructions(sass).items()}


def inner_loop(insns):
    """The innermost loop of one kernel that holds its FP32 work: the
    shortest span from a backward branch's target to the branch that
    holds at least half of the kernel's FFMA, FMUL and FADD. Returns
    (Counter of its opcodes, as census, or None when there is none, its
    first and last address)."""
    addrs = [a for a, _, _ in insns]
    fp32 = [0]   # prefix counts
    for _, op, _ in insns:
        fp32.append(fp32[-1] + (op.split(".")[0] in _FP32))
    best = None
    for i, (addr, op, args) in enumerate(insns):
        m = _TARGET.search(args)
        if not (op.startswith("BRA") and m) or int(m.group(1), 16) >= addr:
            continue
        j = bisect.bisect_left(addrs, int(m.group(1), 16))
        if fp32[-1] and 2 * (fp32[i + 1] - fp32[j]) >= fp32[-1] and (
                best is None or i - j < best[1] - best[0]):
            best = (j, i)
    if best is None:
        return None, None, None
    j, i = best
    return _count(insns[j:i + 1]), addrs[j], addrs[i]


def summary(counts: collections.Counter) -> dict:
    out = {"instructions": counts["_total"]}
    for w in WATCH:
        n = sum(c for op, c in counts.items()
                if op == w or op.startswith(w + "."))
        if n:
            out[w] = n
    return out


def run(lib_path=None, out=None, every=False) -> dict:
    """{kernel name: (summary, summary of its inner_loop or None)}."""
    sass = disassemble(lib_path)
    if out:
        with open(out, "w") as f:
            f.write(sass)
    per = instructions(sass)
    names = demangle(list(per))
    rec = {}
    for k, insns in per.items():
        if every or any(w in names[k] for w in SELECT):
            body = inner_loop(insns)[0]
            rec[names[k]] = (summary(_count(insns)),
                             None if body is None else summary(body))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the whole disassembly here")
    ap.add_argument("--all", action="store_true", help="every kernel")
    a = ap.parse_args(argv)
    for name, (s, body) in run(out=a.out, every=a.all).items():
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in s.items()))
        if body:
            print("  innermost FP32 loop: "
                  + ", ".join(f"{k} {v}" for k, v in body.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
