"""Counts the SASS instructions of one kernel in built kernel libraries:
its instructions in all and the named opcodes (by default the 64-bit
carries ``IMAD.X`` on the FMA pipe and ``IADD3.X`` on the integer pipe,
which tell how a kernel's addresses are computed). Needs ``cuobjdump``
(the CUDA toolkit); one line for each library and matching kernel:

    python -m simplex_tpu_torch.bench.sass_ops --kernel 'bf16x4_kernelIfLb0E' build/kernels
    python -m simplex_tpu_torch.bench.sass_ops --kernel 'bf16x4_kernelILb0E' path/to/parent/build/kernels

``--kernel`` is a regular expression searched in the mangled names. An
opcode in ``--ops`` with a modifier (``IMAD.X``) counts that opcode alone;
one without (``DMMA``) counts it under every modifier (``DMMA.884``,
``DMMA.16816``, ...):

    python -m simplex_tpu_torch.bench.sass_ops --kernel 'dmma_kernelId' --ops DMMA,DFMA build/kernels

``--compare`` holds two builds against each other (a parent checkout's
and a change's): every matching kernel's count of every opcode, keyed by
its mangled name without the hash nvcc gives a source's anonymous
namespace (which changes with the source's text); one line a kernel, then
the verdict, exit 1 unless both builds hold the same kernels with the same
counts:

    python -m simplex_tpu_torch.bench.sass_ops --kernel 'batch_pricing' --compare \
        path/to/parent/build/kernels build/kernels
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
from pathlib import Path

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]+)")
# nvcc's name of a source's anonymous namespace: a hash of the file's text
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_[0-9]+_(\w+?)_cu_[0-9a-f]{8}")


def opcode_counts(lib: Path, kernel: str) -> dict:
    """{mangled name: Counter of opcodes} of the kernels in ``lib`` whose
    mangled name matches ``kernel``."""
    sass = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if re.search(kernel, name):
            found[name] = collections.Counter(_OP.findall(fn))
    return found


def count(c: collections.Counter, op: str) -> int:
    """Instructions of opcode ``op``: exactly, or under any modifier where
    ``op`` names none."""
    if "." in op:
        return c[op]
    return sum(k for name, k in c.items() if name == op or name.startswith(op + "."))


def stable_counts(d: str, kernel: str) -> dict:
    """{mangled name without the anonymous namespace's hash: Counter} over
    the libraries in directory ``d``."""
    out = {}
    for lib in sorted(Path(d).glob("libsimplex_kernels_*.so")):
        for name, c in opcode_counts(lib, kernel).items():
            out[_ANON.sub(r"anon_\1", name)] = c
    return out


def compare(a: str, b: str, kernel: str) -> int:
    ca, cb = stable_counts(a, kernel), stable_counts(b, kernel)
    same = 0
    for name in sorted(set(ca) | set(cb)):
        if ca.get(name) == cb.get(name):
            same += 1
            print(f"same: {name}: instructions {sum(ca[name].values())}")
        else:
            na = sum(ca[name].values()) if name in ca else "absent"
            nb = sum(cb[name].values()) if name in cb else "absent"
            print(f"DIFFERENT: {name}: instructions {na} vs {nb}")
    total = len(set(ca) | set(cb))
    print(f"{same} of {total} kernels matching {kernel!r} have the same opcode counts in both builds")
    return 0 if total and same == total else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m simplex_tpu_torch.bench.sass_ops")
    ap.add_argument("--kernel", required=True, help="a regular expression on the mangled name")
    ap.add_argument("--ops", default="IMAD.X,IADD3.X", help="opcodes to count, comma-separated")
    ap.add_argument("--compare", action="store_true",
                    help="two directories: every opcode count of each kernel, one build against the other")
    ap.add_argument("dirs", nargs="+", help="directories of libsimplex_kernels_*.so")
    args = ap.parse_args(argv)
    if args.compare:
        if len(args.dirs) != 2:
            ap.error("--compare takes two directories")
        return compare(*args.dirs, args.kernel)
    for d in args.dirs:
        for lib in sorted(Path(d).glob("libsimplex_kernels_*.so")):
            for name, c in opcode_counts(lib, args.kernel).items():
                ops = " ".join(f"{op} {count(c, op)}" for op in args.ops.split(","))
                print(f"{lib}: {name}: instructions {sum(c.values())} {ops}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
