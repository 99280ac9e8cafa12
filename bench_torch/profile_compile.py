#!/usr/bin/env python3
"""Where the time of the port's compile path goes on the card.

Runs `compile_bank(cfg, simulate=True, solver="pallas")` once to warm up
for a 16x64 gc2t_nn bank, then times each stage of the compile flow on
the host clock (bank build, analytic timing, retention, netlist export,
the transient read, power), each ending in a device synchronize, and
profiles the transient read under `torch.profiler` with CPU and CUDA
activities: device time by kernel name (device-side events only), the
wall time, and the device's busy and idle shares (busy = summed kernel
time / wall time; the path runs on one stream, so kernels do not
overlap). Prints a summary and writes the full table to
chiprun_out/profile_compile.json. Needs a CUDA device; exits nonzero
without one.

Run from the root of the repository: python3 bench_torch/profile_compile.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_compile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import power, retention, timing
    from repro_torch.core.bank import BankConfig, build_bank
    from repro_torch.core.compiler import circuit_to_spice, compile_bank

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cfg = BankConfig(16, 64, cell="gc2t_nn")
    compile_bank(cfg, simulate=True, solver="pallas", device="cuda")

    stages = {}
    bank, stages["build_bank"] = _timed(lambda: build_bank(cfg))
    t, stages["timing.analyze"] = _timed(lambda: timing.analyze(bank))
    ret, stages["retention.analyze"] = _timed(lambda: retention.analyze(
        bank.cell, cfg.tech, wwlls=cfg.wwlls, wwl_boost=cfg.wwl_boost,
        device="cuda"))
    _, stages["read_netlist + circuit_to_spice"] = _timed(
        lambda: circuit_to_spice(timing.read_netlist(bank)[0], "read"))
    _, stages["timing.simulate_read (pallas)"] = _timed(
        lambda: timing.simulate_read(bank, solver="pallas", device="cuda"))
    _, stages["power.analyze"] = _timed(lambda: power.analyze(
        bank, t.f_max_hz, t_ret_s=ret.t_ret_s))
    _, whole_ms = _timed(lambda: compile_bank(
        cfg, simulate=True, solver="pallas", device="cuda"))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = _timed(lambda: timing.simulate_read(
            bank, solver="pallas", device="cuda"))
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
    out = {"card": card, "config": "gc2t_nn 16x64, simulate=True, pallas",
           "stages_ms": stages, "compile_bank_ms": whole_ms,
           "profiled_simulate_read_wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernels": rows}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_compile.json").write_text(json.dumps(out, indent=1))
    print(f"card: {card}")
    print(f"compile_bank gc2t_nn 16x64 simulate pallas warm: {whole_ms!r} ms")
    for name, ms in stages.items():
        print(f"  {ms!r:>24} ms  {name}")
    print(f"simulate_read under the profiler: wall {wall_ms!r} ms, device "
          f"busy {busy_ms!r} ms, idle share {out['device_idle_share']!r}")
    for r in rows[:12]:
        print(f"  {r['device_ms']!r:>24} ms  x{r['count']:<6} {r['name'][:90]}")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
