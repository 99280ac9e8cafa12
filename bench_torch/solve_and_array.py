#!/usr/bin/env python3
"""The Gauss-Jordan and array-step kernels of one source tree, timed on
the card, with the walls of the paths that run them.

For the `repro_torch` under `--src` it times, on NVIDIA hardware:
  - `batched_solve` on the compile path's read-column systems (N = 13,
    float64) at B = 1 and B = 4096: CUDA events over back-to-back calls,
    the profiler's device time, and the wrapper's host time (a host clock
    over 1000 calls with no synchronize inside);
  - `gc_array_step` at 512x512 and 128x128: events and device time;
  - the array path's 200-step write of a 512x512 array: events around
    the 200 calls, three runs, and the profiler's device time of its
    launches, whose sum over the events wall is the card's busy share;
  - the compile path's wall: `compile_bank(16x64 gc2t_nn, simulate=True,
    solver="pallas")`, warm, two runs.
Each kernel's output is hashed, so that two trees can be held to the same
bits. To compare two trees, run it for each in turns (parent, change,
change, parent) on one card: `--src build/parent/src` for a parent
commit unpacked there with `git archive`. Prints one line
per measurement and a JSON summary line. Needs a CUDA device; exits
nonzero without one.

Run from the root of the repository:
    python3 bench_torch/solve_and_array.py [--src DIR] [--tag NAME]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the summary line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_and_array: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"solve_and_array: imported {repro_torch.__file__}, not from "
              f"{src}", file=sys.stderr)
        return 1
    from chip_smoke import (WRITE_STEPS, array_inputs, device_ms, host_us,
                            read_column_systems, time_ms, write_inputs)
    from repro_torch.core.bank import BankConfig
    from repro_torch.core.compiler import compile_bank
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.kernels.gc_array_step import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    tag = args.tag or str(src)
    out = {"tag": tag, "card": card}

    for B in (1, 4096):
        J, r = read_column_systems(dev, B)
        kern = lambda: batched_solve(J, r)
        k1, k2 = time_ms(kern, 500), time_ms(kern, 500)
        wrap = host_us(kern)
        d = device_ms(kern, "gauss_jordan")
        h = digest(kern())
        out[f"gauss_jordan B={B}"] = dict(ms=(k1 + k2) / 2, device_ms=d,
                                          host_us=wrap, digest=h)
        print(f"[{tag}] gauss_jordan B={B} N=13 f64: events {k1!r} / {k2!r} "
              f"ms, device {d!r} ms, wrapper host {wrap!r} us per call, "
              f"output {h} [{card}]", flush=True)

    p = ops.cell_params("gc2t_nn")
    for R in (512, 128):
        a = array_inputs(R, R, dev)
        kern = lambda: ops.gc_array_step(*a, 1e-11, p)
        k1, k2 = time_ms(kern, 20), time_ms(kern, 20)
        d = device_ms(kern, "gc_array_step_kernel", reps=10)
        h = digest(*kern())
        out[f"gc_array_step {R}x{R}"] = dict(ms=(k1 + k2) / 2, device_ms=d,
                                             digest=h)
        print(f"[{tag}] gc_array_step {R}x{R}: events {k1!r} / {k2!r} ms, "
              f"device {d!r} ms, output {h} [{card}]", flush=True)

    v_sn, v_bl, wwl, wbl, rwl = write_inputs(512, 512, dev)

    def write():
        sn, bl = v_sn, v_bl
        for _ in range(WRITE_STEPS):
            sn, bl = ops.gc_array_step(sn, bl, wwl, wbl, rwl, 1e-11, p)
        return sn, bl
    walls = [time_ms(write, 1, warm=1) for _ in range(3)]
    per_step = device_ms(write, "gc_array_step_kernel", reps=2)
    h = digest(*write())
    out["array write"] = dict(ms=walls, device_ms_per_step=per_step,
                              digest=h)
    print(f"[{tag}] array write {WRITE_STEPS} steps 512x512 (events): "
          f"{', '.join(repr(w) for w in walls)} ms; device {per_step!r} ms "
          f"per step, {per_step * WRITE_STEPS!r} ms per write; output {h} "
          f"[{card}]", flush=True)

    cfg = BankConfig(16, 64, cell="gc2t_nn")
    compile_bank(cfg, simulate=True, solver="pallas", device="cuda")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = compile_bank(cfg, simulate=True, solver="pallas",
                           device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["compile wall"] = dict(s=walls, t_cell_s=rep.t_cell_sim_s)
    print(f"[{tag}] compile_bank gc2t_nn 16x64 pallas warm: "
          f"{', '.join(repr(w) for w in walls)} s, t_cell "
          f"{rep.t_cell_sim_s!r} s [{card}]", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
