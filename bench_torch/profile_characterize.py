#!/usr/bin/env python3
"""Where the time of the port's main path goes on the card.

Runs `characterize` over the default 96-point lattice (f64) once to warm
up, then once under `torch.profiler` with CPU and CUDA activities, and
reports the device time by kernel name (device-side events only, so a
host op and the kernels it launched are not counted twice), the wall time, and the device's
busy and idle shares (busy = summed kernel time / wall time; the path
runs on one stream, so kernels do not overlap). Prints a summary and
writes the full table to chiprun_out/profile_characterize.json.
Needs a CUDA device; exits nonzero without one.

Run from the root of the repository: python3 bench_torch/profile_characterize.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_characterize: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.spice.char_batch import characterize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cfgs = lattice_configs()
    characterize(cfgs, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        characterize(cfgs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue     # host ops: their device time is their kernels'
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key, "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    out = {"card": card, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3),
           "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "kernels": rows}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_characterize.json").write_text(json.dumps(out, indent=1))
    print(f"card: {card}")
    print(f"characterize 96 points f64 under the profiler: wall "
          f"{out['wall_ms']!r} ms, device busy {busy_ms!r} ms, idle share "
          f"{out['device_idle_share']!r}")
    for r in rows[:12]:
        print(f"  {r['device_ms']!r:>24} ms  x{r['count']:<6} {r['name'][:90]}")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
