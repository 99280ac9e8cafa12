#!/usr/bin/env python3
"""Static instruction mix of a port kernel's SASS.

Builds `csrc/<name>.cu` of the `repro_torch` under `--src` (if it is not
built yet), disassembles the library with `cuobjdump -sass`, and prints,
for each kernel whose name holds `--match`, its instruction count and the
most frequent opcodes (the first word of each instruction, predicates and
modifiers dropped: DFMA.RM counts as DFMA). Static counts: each
instruction once, however often it runs. Needs the CUDA toolkit
(`nvcc`, `cuobjdump`); exits nonzero without it.

Run from the root of the repository:
    python3 bench_torch/sass_mix.py [--src DIR] [--name fused_newton]
        [--match "double, double, 2, true"] [--top 25]
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--name", default="fused_newton")
    ap.add_argument("--match", default="double, double, 2, true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build
    lib = build.build_all([args.name])[args.name]
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    demangled = subprocess.run(
        ["c++filt"], input="\n".join(f.split("\n", 1)[0].strip()
                                     for f in funcs),
        capture_output=True, text=True).stdout.splitlines()
    found = 0
    for name, body in zip(demangled, funcs):
        if args.match not in name:
            continue
        found += 1
        ops = collections.Counter(m.group(1) for m in INSTR.finditer(body))
        print(f"{name[:140]}\n  {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in
                          ops.most_common(args.top)))
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
