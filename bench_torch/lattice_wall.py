#!/usr/bin/env python3
"""Warm wall time of the port's lattice path on the card.

Times `characterize(lattice_configs())` (96 points, f64, 300 steps) on
the card: one call to warm up (and build the kernels), then `--runs`
calls, each between synchronizes. `--src` names the `src` directory whose
`repro_torch` is timed, so that two trees (say a parent commit unpacked
with `git archive` and this one) can be compared on one card in one
session, in turns. With `--scan-reps N` it also times the fused Newton
scan kernel on the lattice's first topology group (16 lanes, 300 steps,
f64) by CUDA events over N launches, and prints a digest of its output,
so that two versions of the kernel can be held to the same bits. Prints
one line per run and a JSON summary line. Needs a CUDA device; exits
nonzero without one.

Run from the root of the repository:
    python3 bench_torch/lattice_wall.py [--src DIR] [--runs N] [--scan-reps N]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--scan-reps", type=int, default=0,
                    help="launches of the scan kernel to time (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lattice_wall: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"lattice_wall: imported {repro_torch.__file__}, not from "
              f"{src}", file=sys.stderr)
        return 1
    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.spice.char_batch import characterize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cfgs = lattice_configs()
    characterize(cfgs, device="cuda")
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chars = characterize(cfgs, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"characterize 96 points f64 warm: {walls[-1]!r} s [{src}]",
              flush=True)
    if not all(c is not None and c.t_cell_s > 0 for c in chars):
        print("lattice_wall: a point has no finite t_cell", file=sys.stderr)
        return 1
    out = {"src": str(src), "card": card, "walls_s": walls,
           "median_s": statistics.median(walls)}
    if args.scan_reps > 0:
        out.update(time_scan(cfgs, args.scan_reps))
    print(json.dumps(out))
    return 0


def time_scan(cfgs, reps: int) -> dict:
    """Events time per launch of `ops.fused_newton_scan` on the first
    topology group's inputs, as `Transient._run_lattice_fused` forms
    them, and a digest of its output."""
    from repro_torch.core.bank import build_bank
    from repro_torch.core.dse_batch import group_by_topology
    from repro_torch.core.spice.char_batch import group_inputs
    from repro_torch.kernels.batched_solve import newton as nwt
    from repro_torch.kernels.batched_solve import ops
    from repro_torch.kernels.batched_solve.sparse import pack_params
    n_steps = 300
    idx = next(iter(group_by_topology(cfgs).values()))
    group = [cfgs[i] for i in idx]
    inp = group_inputs(group, [build_bank(c) for c in group], n_seg=8,
                       n_steps=n_steps, device="cuda")
    tr = inp["tr"]
    f64 = dict(dtype=torch.float64, device="cuda")
    te, wt, wv = (torch.as_tensor(inp[k], **f64)
                  for k in ("t_end", "wt", "wv"))
    pre = nwt.precompute(tr.spec, inp["over"]["G"], inp["over"]["C"],
                         te / n_steps)
    Ksrc = torch.einsum("bij,btj->tbi", pre["K"],
                        tr.src_sequence(te, wt, wv, n_steps)).contiguous()
    B = te.shape[0]
    params = pack_params(tr.system.dev, B, torch.float64, {})
    v0 = inp["v0"].expand(B, tr.spec.n).contiguous()

    def scan():
        return ops.fused_newton_scan(tr.spec, pre, Ksrc, params, v0,
                                     iters=tr.iters, tol=tr.tol)

    vs = scan()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        scan()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    digest = hashlib.sha256(vs.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"fused_newton_scan B={B} T={n_steps} f64: {ms!r} ms per launch "
          f"(events, {reps} launches), output digest {digest}", flush=True)
    return {"scan_ms": ms, "scan_digest": digest}


if __name__ == "__main__":
    sys.exit(main())
