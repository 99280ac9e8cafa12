#!/usr/bin/env python3
"""Both flash-attention kernels of one source tree, timed on the card.

For the `repro_torch` under `--src` it times, on NVIDIA hardware:
  - the float32 kernel (`csrc/flash_attention.cu`) at the full-width
    float32 serve's four prefill shapes (B = 2, S = 128, 256, 512 and
    1024, H = 32, K = 8, hd = 64) and at the 2-layer float32 serve's two
    (B = 1, S = 96 and 200), and the bf16 tensor-core kernel
    (`csrc/flash_attention_tc.cu`) at the four: CUDA events over
    back-to-back calls (two runs), the profiler's device time, the plain
    version and `scaled_dot_product_attention` in turns in the same
    process, the bound and the achieved TFLOP/s, with a hash of each
    kernel's output;
  - the float32 serve's flash device time: each of the four shapes is
    launched 32 times in one serve (two admission groups x 16 layers), so
    32 x the summed device time per launch;
  - each wrapper's host time per call: the median of five runs of a host
    clock over 500 calls with no synchronize inside, at a shape small
    enough (B = 1, S = 16, H = 8, K = 2) that the card keeps up.
To compare two trees, run it for each in turns (parent, change, change,
parent) on one card: `--src build/parent/src` for a parent commit
unpacked there with `git archive`. Prints one line per measurement and a
JSON summary line. Needs a CUDA device; exits nonzero without one.

Run from the root of the repository:
    python3 bench_torch/flash_f32.py [--src DIR] [--tag NAME]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WRAPPER_SHAPE = (1, 16, 16, 8, 2, 64, 0, None)


def digest(t) -> str:
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the summary line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"flash_f32: imported {repro_torch.__file__}, not from {src}",
              file=sys.stderr)
        return 1
    from chip_smoke import (F32_FLASH_SHAPES, SERVE_FLASH_SHAPES,
                            SERVE_LAUNCHES_PER_SHAPE, flash_inputs, host_us,
                            time_flash_shapes)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    tag = args.tag or str(src)
    out = {"tag": tag, "card": card}

    for dtype, label, name, shapes in (
            (torch.float32, "f32", "flash_attention_kernel",
             SERVE_FLASH_SHAPES + F32_FLASH_SHAPES),
            (torch.bfloat16, "tc", "flash_attention_tc_kernel",
             SERVE_FLASH_SHAPES)):
        print(f"[{tag}] {label}:", flush=True)
        rows = time_flash_shapes(dev, card, shapes, dtype, name)
        rows.pop("mix")
        for shape in shapes:
            q, k, v = flash_inputs(shape, dtype, dev)
            rows[f"B={shape[0]} S={shape[1]}"]["digest"] = digest(
                flash_attention_fwd(q, k, v))
        serve = [rows[f"B={s[0]} S={s[1]}"]["device_ms"]
                 for s in SERVE_FLASH_SHAPES]
        serve_ms = (None if None in serve
                    else SERVE_LAUNCHES_PER_SHAPE * sum(serve))
        q, k, v = flash_inputs(WRAPPER_SHAPE, dtype, dev)
        wrap = statistics.median(
            host_us(lambda: flash_attention_fwd(q, k, v), calls=500)
            for _ in range(5))
        out[label] = dict(shapes=rows, serve_device_ms=serve_ms,
                          wrapper_host_us=wrap)
        print(f"[{tag}] {label}: "
              + ", ".join(f"{key} output {r['digest']}"
                          for key, r in rows.items())
              + f"; flash device ms per full-width serve {serve_ms!r} "
              f"({SERVE_LAUNCHES_PER_SHAPE} launches of each of the four "
              f"shapes); wrapper host {wrap!r} us per call [{card}]",
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
