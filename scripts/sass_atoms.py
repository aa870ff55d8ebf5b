"""Count the shared-memory and global atomic instructions of each kernel in
a built library's SASS.

    python3 scripts/sass_atoms.py LIBRARY [NAME ...]

Runs ``cuobjdump -sass`` on LIBRARY (a ``build/repro_torch/*.so``) and,
for each kernel whose mangled name holds one of the NAMEs (every kernel
when none is given), prints the count of each atomic opcode it holds
(``ATOMS.*``, ``ATOMG.*``, ``RED.*``, ``ATOM.*``), so a compare-and-swap
loop (``ATOMS.CAST.SPIN``) shows beside native adds (``ATOMS.ADD``).
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys

ATOMIC = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)\b")


def kernels(sass: str):
    """(mangled name, its SASS) of each function in cuobjdump's output."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    return list(zip(parts[1::2], parts[2::2]))


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sass = subprocess.run(["cuobjdump", "-sass", argv[0]], check=True,
                          capture_output=True, text=True).stdout
    for name, body in kernels(sass):
        if argv[1:] and not any(k in name for k in argv[1:]):
            continue
        counts = collections.Counter(ATOMIC.findall(body))
        print(name, dict(sorted(counts.items())) or "no atomics")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
