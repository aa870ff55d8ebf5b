"""Count the ensemble kernel's SASS instructions by the pipe that issues
them, over its hop loop and over the whole kernel.

    python3 scripts/sass_pipes.py LIBRARY [NAME ...]

Runs ``cuobjdump -sass`` on LIBRARY (a built ``build/repro_torch/
traversal-*.so``) and, for each kernel whose mangled name holds one of the
NAMEs (``ensemble_kernel`` when none is given), finds the hop loop: the
backward branch whose body holds the most shared loads, which is the loop
over a class's trees in a staged block (one iteration walks U records
through one tree: DEPTH x U hops, then U leaf adds).  It prints that loop's
instruction count by pipe, over the iteration and over a hop (the loop's
count divided by DEPTH x U, read from the kernel's template arguments), and
the whole kernel's by pipe, then one JSON line with every count.

Pipes, by opcode (the part before the first dot):

* ``int``: the integer ALU pipe, 64 lanes an SM a clock on the H100 (half
  the FP32 rate): IADD3, LOP3, SHF, PRMT, ISETP, SEL, LEA, VIMNMX, IMNMX,
  IABS, FLO, POPC, BMSK, SGXT, PLOP3, P2R, R2P, MOV, FSEL, FMNMX and
  FSETP (the float compares issue there too: on an H100, four FSETP
  chains beside four LOP3 chains run as long as eight LOP3 chains, where
  four IMAD, FFMA or VIADD chains beside them take two thirds or half);
* ``fma``: the FMA pipe: FFMA, FADD, FMUL, IMAD (every form: IMAD.MOV,
  IMAD.SHL, IMAD.IADD, IMAD.WIDE, IMAD.HI), VIADD, IDP, HFMA2, HADD2,
  HMUL2;
* ``lds``: shared-memory loads (LDS of any width), ``sts``: shared stores;
* ``global``: LDG, STG, and the constant loads LDC, ULDC;
* ``uniform``: the uniform datapath (U* opcodes but ULDC), which runs
  beside the warp's own pipes;
* ``branch``: BRA, BSSY, BSYNC, EXIT, BAR, WARPSYNC, CALL, RET, NOP;
* ``other``: the rest (conversions, S2R, ...).
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys

INT = {"IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "VIMNMX",
       "IMNMX", "IABS", "FLO", "POPC", "BMSK", "SGXT", "PLOP3", "P2R", "R2P",
       "MOV", "FSEL", "FMNMX", "FSETP"}
FMA = {"FFMA", "FADD", "FMUL", "IMAD", "VIADD", "IDP", "HFMA2", "HADD2",
       "HMUL2"}
BRANCH = {"BRA", "BSSY", "BSYNC", "EXIT", "BAR", "WARPSYNC", "CALL", "RET",
          "NOP"}
GLOBAL = {"LDG", "STG", "LDC", "ULDC"}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
TEMPLATE = re.compile(r"ILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E")


def pipe(op: str) -> str:
    base = op.split(".")[0]
    if base in INT:
        return "int"
    if base in FMA:
        return "fma"
    if base == "LDS":
        return "lds"
    if base == "STS":
        return "sts"
    if base in GLOBAL:
        return "global"
    if base in BRANCH:
        return "branch"
    if base.startswith("U"):
        return "uniform"
    return "other"


def kernels(sass: str):
    """(mangled name, its SASS) of each function in cuobjdump's output."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    return list(zip(parts[1::2], parts[2::2]))


def instructions(body: str):
    """[(address, opcode, operands)] of one function's SASS."""
    return [(int(m.group(1), 16), m.group(3), m.group(4))
            for m in LINE.finditer(body)]


def hop_loop(ins):
    """(first, last) index of the backward branch's body that holds the
    most shared loads, or None."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    best, best_lds = None, 0
    for i, (a, op, rest) in enumerate(ins):
        if op.split(".")[0] != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)", rest)
        if not target or int(target.group(1), 16) >= a:
            continue
        first = at.get(int(target.group(1), 16))
        if first is None:
            continue
        lds = sum(o.startswith("LDS") for _, o, _ in ins[first:i + 1])
        if lds > best_lds:
            best, best_lds = (first, i), lds
    return best


def count(ins) -> dict:
    by_pipe = collections.Counter(pipe(op) for _, op, _ in ins)
    return dict(sorted(by_pipe.items()), total=len(ins))


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    names = argv[1:] or ["ensemble_kernel"]
    sass = subprocess.run(["cuobjdump", "-sass", argv[0]], check=True,
                          capture_output=True, text=True).stdout
    rows = []
    for name, body in kernels(sass):
        if not any(k in name for k in names):
            continue
        ins = instructions(body)
        row = {"kernel": name, "whole": count(ins)}
        t = TEMPLATE.search(name)
        loop = hop_loop(ins)
        if t and loop:
            depth, U = int(t.group(1)), int(t.group(2))
            body_ins = ins[loop[0]:loop[1] + 1]
            row["template"] = dict(depth=depth, U=U, staged=t.group(3) == "1",
                                   nibble=t.group(4) == "1")
            row["loop"] = count(body_ins)
            row["hop"] = {k: v / (depth * U) for k, v in row["loop"].items()}
            row["loop_opcodes"] = dict(sorted(collections.Counter(
                op for _, op, _ in body_ins).items()))
        rows.append(row)
        print(name)
        for part in ("loop", "hop", "whole"):
            if part in row:
                print(f"  {part:5s} " + "  ".join(
                    f"{k} {v:g}" for k, v in row[part].items()))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
