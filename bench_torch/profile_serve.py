#!/usr/bin/env python3
"""Where the time of the port's serving path goes on the card.

Serves the chip-smoke workload (`llama3.2-1b` at full width in bf16 with
seeded weights; 16 requests with prompts of 128, 256, 512 and 1024
tokens, 64 new tokens each, half greedy and half top-k sampled) through
`ServeEngine(n_slots=8, window=2048, decode_chunk=8)` once to warm up,
then once more with the engine's stages timed on the host clock (no
extra synchronization, so the pipelining is the engine's own):
  admit      `_admit_group`: prefill enqueue, first-token sampling and the
             blocking copy of the first tokens (one per prefill);
  dispatch   `_dispatch_chunk`: enqueue of one 8-token decode chunk;
  reconcile  `_reconcile`: the wait for a chunk's tokens and the host
             bookkeeping;
and then a third time under `torch.profiler` (CPU and CUDA activities):
device time by kernel name, the device time of the prefill attention
kernel (the bf16 tensor-core flash-attention kernel,
`flash_attention_tc_kernel`) on its own line, and the device time inside
`Model.prefill` and `Model.decode_loop`, marked with `record_function`.
The device's busy share is the summed kernel time (one stream, so
kernels do not overlap) over the wall of the second, unprofiled serve:
the profiler's own host cost stretches the profiled wall (about twice as
long) but not the kernels. The profiled wall's share is kept too, labelled as such.
Prints a summary and writes everything to chiprun_out/profile_serve.json.
Needs a CUDA device; exits nonzero without one.

Run from the root of the repository: python3 bench_torch/profile_serve.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FLASH_KERNEL = "flash_attention_tc_kernel"   # every bf16 prefill attention


def _wrap(obj, name, sink, label=None, annotate=False):
    """Replace obj.name by a wrapper that adds its host seconds to
    sink[label] (and marks a profiler range if `annotate`)."""
    from torch.profiler import record_function
    fn = getattr(obj, name)
    label = label or name

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        if annotate:
            with record_function(label):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        sink[label] = sink.get(label, 0.0) + time.perf_counter() - t0
        return out
    setattr(obj, name, wrapped)


def _engine(model, cfg, requests):
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, model, n_slots=8, window=2048, mode="device",
                      decode_chunk=8, seed=0)
    for r in requests:
        eng.submit(r)
    return eng


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import serve_requests
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cfg = get_config("llama3.2-1b")
    model = Model(cfg, device="cuda", seed=0)
    _engine(model, cfg, serve_requests(cfg.vocab_size)).run()     # warm
    torch.cuda.synchronize()

    stages = {}
    eng = _engine(model, cfg, serve_requests(cfg.vocab_size))
    for name in ("_admit_group", "_dispatch_chunk", "_reconcile"):
        _wrap(eng, name, stages)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    stages_ms = {k: v * 1e3 for k, v in stages.items()}
    stages_ms["other host"] = wall_s * 1e3 - sum(stages_ms.values())

    model_ms = {}
    _wrap(model, "prefill", model_ms, "serve.prefill", annotate=True)
    _wrap(model, "decode_loop", model_ms, "serve.decode_loop", annotate=True)
    eng = _engine(model, cfg, serve_requests(cfg.vocab_size))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ranges = [], {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.key in model_ms and ev.device_type != \
                torch.autograd.DeviceType.CUDA:
            ranges[ev.key] = {
                "count": ev.count,
                "host_ms": ev.cpu_time_total / 1e3,
                "device_ms": getattr(ev, "device_time_total",
                                     getattr(ev, "cuda_time_total", 0.0))
                / 1e3}
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0 \
                and ev.key not in model_ms:
            rows.append({"name": ev.key, "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    flash = [r for r in rows if FLASH_KERNEL in r["name"]]
    flash_ms = sum(r["device_ms"] for r in flash)
    flash_n = sum(r["count"] for r in flash)
    out = {"card": card, "config": "llama3.2-1b bf16, 16 requests, 8 slots, "
           "window 2048, decode_chunk 8",
           "wall_s": wall_s, "stages_host_ms": stages_ms,
           "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall_s * 1e3),
           "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
           "device_idle_share_of_profiled_wall":
               1.0 - busy_ms / prof_wall_ms,
           "flash_kernel": {"name": FLASH_KERNEL, "count": flash_n,
                            "device_ms": flash_ms},
           "ranges": ranges, "kernels": rows}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_serve.json").write_text(json.dumps(out, indent=1))
    print(f"card: {card}")
    print(f"serve {out['config']} warm: {wall_s!r} s")
    for name, ms in stages_ms.items():
        print(f"  {ms!r:>24} ms host  {name}")
    print(f"device busy {busy_ms!r} ms (profiled run): idle share "
          f"{out['device_idle_share']!r} of the unprofiled wall; profiled "
          f"wall {prof_wall_ms!r} ms, idle share "
          f"{out['device_idle_share_of_profiled_wall']!r} of it")
    for name, r in ranges.items():
        print(f"  {name}: x{r['count']}, host {r['host_ms']!r} ms, device "
              f"{r['device_ms']!r} ms")
    print(f"  {FLASH_KERNEL}: x{flash_n}, device {flash_ms!r} ms"
          f"{f' ({flash_ms / flash_n!r} ms each)' if flash_n else ''}")
    for r in rows[:15]:
        print(f"  {r['device_ms']!r:>24} ms  x{r['count']:<6} "
              f"{r['name'][:90]}")
    return 0 if rows and flash_n else 1


if __name__ == "__main__":
    sys.exit(main())
