#!/usr/bin/env python3
"""Warm serve walls of one source tree's `repro_torch` on the card.

For the `repro_torch` under `--src` it serves chip_smoke.py's 16-request
workload (seeded prompts, 64 new tokens each, half greedy and half top-k
sampled) through `ServeEngine(n_slots=8, decode_chunk=8)` in device mode,
at full width in bf16 with seeded weights, for the archs of the smoke's
dense serve (llama3.2-1b, prompts 128-1024, window 2048) and of its
phase 11c (xlstm-1.3b, prompts 64-512, window 2048; whisper-large-v3,
prompts 32-192, window 448; internvl2-1b, prompts 128-1024 after 256
patches, window 2048). Each arch is served once to warm up, then `--reps`
times on the host clock (a synchronize before and after each serve); the
median is kept with every run and a digest of the greedy streams, so
two trees can be held to the same tokens.

To compare two trees, run it for each in turns (parent, change, change,
parent) on one card: `--src build/parent/src` for a parent commit
unpacked there with `git archive`. Prints one line per serve and a JSON
summary line. Needs a CUDA device; exits nonzero without one.

Run from the root of the repository:
    python3 bench_torch/serve_wall.py [--src DIR] [--tag NAME] [--reps N]
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
    ap.add_argument("--tag", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_wall: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"serve_wall: imported {repro_torch.__file__}, not from "
              f"{src}", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_all
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    tag = args.tag or str(src)
    build_all()
    dev = torch.device("cuda")
    serves = (("llama3.2-1b", c.SERVE_LENS, c.SERVE_WINDOW),
              ("xlstm-1.3b", c.XLSTM_LENS, c.SERVE_WINDOW),
              ("whisper-large-v3", c.WHISPER_LENS, c.WHISPER_CONTEXT),
              ("internvl2-1b", c.VLM_LENS, c.VLM_WINDOW))
    out = {}
    for arch, lens, window in serves:
        cfg = get_config(arch)
        model = Model(cfg, device=dev, seed=c.SEED)
        c.run_engine(model, cfg, "device", lens, window)        # warm
        walls, digest = [], None
        for _ in range(args.reps):
            _, streams, wall = c.run_engine(model, cfg, "device", lens,
                                            window)
            walls.append(wall)
            greedy = [streams[r] for r in sorted(streams) if r % 2 == 0]
            digest = hashlib.sha256(json.dumps(greedy).encode()) \
                .hexdigest()[:16]
        out[arch] = {"wall_s": statistics.median(walls), "walls_s": walls,
                     "greedy_digest": digest}
        print(f"serve_wall {tag} {arch}: warm walls {walls!r} s, median "
              f"{statistics.median(walls)!r} s, greedy digest {digest} "
              f"[{card}]", flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"tag": tag, "card": card, "serves": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
