#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, without an NVIDIA card (or with fewer
cards than the cell asks for), when the program cannot be imported, or
when the JAX stack or the JAX package got loaded into this process.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
