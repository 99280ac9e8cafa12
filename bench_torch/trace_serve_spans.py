#!/usr/bin/env python3
"""Where a benchmark serve cell's device time and idle gaps fall among the
program's spans (`repro_torch.runtime.telemetry.span`), on the card.

Runs one `--trace 1` run of a cell of `perfbench` in this process (the
benchmark's own `run_cell`) with the profiler's trace kept: it is written,
gzipped, to `chiprun_out/<cell>.<seed>.trace.json.gz`. From the kept trace
and the span registry it writes `chiprun_out/<cell>.<seed>.spans.json`:
  metrics    the run's per-layer metrics (the benchmark's readers);
  spans      device ms and count of each span name under `model.prefill`
             and under `model.decode_loop` (the readers' rule: the root
             began and ended inside the traced stretch), the roots' own
             device ms, rows and steps;
  kernels    kernel ms by the innermost program span the kernel was
             launched in (its launch found by correlation id), under each
             root (the spans' device ms above also hold the device's idle
             inside them), and the ten largest kernels of each root's own
             remainder;
  idle_gaps  the ten longest idle gaps of the device, each with the
             innermost program span over its middle, the harness's `pb.*`
             range there and the innermost host operation;
  clock      the largest distance between a span's profiler range and its
             registry stamp moved by `CLOCK_OFFSET_NS`;
  cost       the host cost of one `span()` with no profiler recording, and
             of one recorded span on the card (a pair of CUDA events and a
             profiler range) under a recording profiler, also with the
             range opened through `torch.profiler.record_function`.

    python3 bench_torch/trace_serve_spans.py [--workload W] [--seed N]
        [--seconds S]

Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
OUT = ROOT / "chiprun_out"
ROOTS = ("model.prefill", "model.decode_loop")    # as the readers' roots


def span_cost(device, n=200_000, n_on=20_000):
    """ns per `with span()` with no profiler recording, per empty loop
    turn, and per recorded span on the card under a recording profiler
    (the program's range, then `torch.profiler.record_function`)."""
    import torch
    from repro_torch.runtime import telemetry
    span = telemetry.span
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    out = {"empty_loop_ns": (time.perf_counter_ns() - t) / n}
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("cost.off", device=device):
            pass
    out["off_ns_per_span"] = (time.perf_counter_ns() - t) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fast = telemetry._RANGE
    for key, rng in (("on_ns_per_span", fast),
                     ("on_ns_per_span_record_function",
                      torch.profiler.record_function)):
        telemetry._RANGE = rng
        with torch.profiler.profile(activities=acts):
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            for _ in range(n_on):
                with span("cost.on", device=device):
                    pass
            out[key] = (time.perf_counter_ns() - t) / n_on
    telemetry._RANGE = fast
    return out


def innermost(intervals, t, last=None):
    """The name of the latest-starting (a, b, name) with a <= t <= b, of
    `intervals` sorted by start; with `last`, among the `last` that start
    last before t."""
    i = bisect.bisect_right(intervals, (t, float("inf")))
    inside = [iv for iv in intervals[max(0, i - (last or i)):i]
              if iv[1] >= t]
    return max(inside)[2] if inside else None


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "overhead", "cuda_runtime", "cuda_driver")


def analyse(trace, names, program):
    """From a chrome trace (the profiler's export, times in us): kernel ms
    by the innermost program span over its launch under each root, the
    ten largest kernels of each root's remainder, the ten longest idle
    gaps by program span, and the largest distance (us) between a span's
    range in the trace and its registry stamp."""
    from repro_torch.runtime.telemetry import CLOCK_OFFSET_NS
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                  e.get("args", {}).get("correlation")) for e in ev
                 if e.get("cat") in DEVICE)
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    host = [e for e in ev if e.get("cat") not in DEVICE + (
        "gpu_user_annotation", "Trace")]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                    if e["name"] in names)
    roots = [iv for iv in ranges if iv[2] in ROOTS]
    notes = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                   if e["name"].startswith("pb."))
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                 if e.get("cat") in HOST_OPS)
    by_span = {r: {} for r in ROOTS}
    remainder = {r: {} for r in ROOTS}
    for a, b, name, corr in dev:
        at_host = launch.get(corr)
        root = innermost(roots, at_host) if at_host is not None else None
        if root is None:
            continue
        # spans nest a few deep: the innermost starts among the last few
        at = innermost(ranges, at_host, last=64) or root
        by_span[root][at] = by_span[root].get(at, 0) + (b - a) / 1e3
        if at == root:
            remainder[root][name[:120]] = \
                remainder[root].get(name[:120], 0) + (b - a) / 1e3
    merged = []
    for a, b, *_ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    out_gaps = [{"ms": g / 1e3, "program_span": innermost(ranges, (a + b) / 2),
                 "pb": innermost(notes, (a + b) / 2),
                 "host_op": innermost(ops, (a + b) / 2)}
                for g, a, b in gaps]
    starts = {}
    for a, _, name in ranges:
        starts.setdefault(name, []).append(a)
    for v in starts.values():
        v.sort()
    base = trace.get("baseTimeNanoseconds", 0)   # ts: us after it
    worst = 0.0
    for s in program:
        at = (s.t0_ns + CLOCK_OFFSET_NS - base) / 1e3
        v = starts.get(s.name, [])
        i = bisect.bisect_left(v, at)
        near = [abs(v[j] - at) for j in (i - 1, i) if 0 <= j < len(v)]
        if near:
            worst = max(worst, min(near))
    top = {r: sorted(([k, v] for k, v in remainder[r].items()),
                     key=lambda x: -x[1])[:10] for r in ROOTS}
    return {"by_span": by_span, "remainder": top}, out_gaps, worst


def by_root(program):
    """Device ms and count of each span name under each counted root, and
    the roots' own ms, count and rows or steps (the readers' `Calls`)."""
    from perfbench.metrics.program_spans import Calls, device_ms
    c = Calls(program)
    out = {}
    for r in ROOTS:
        mine = [s for s in program if s.name == r]
        out[r] = {"ms": device_ms(mine), "n": len(mine),
                  "units": c.rows if r == "model.prefill" else c.steps,
                  "under": {k: {"ms": device_ms(v), "n": len(v)}
                            for k, v in c.under[r].items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mixtral-8L.long-prompt")
    ap.add_argument("--seed", type=int, default=2**31 + 901)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_serve_spans: no CUDA device", file=sys.stderr)
        return 3
    from perfbench.harness import trace
    from perfbench.harness.cli import CACHES, run_cell
    from perfbench.harness.common import find_cell
    from repro_torch.runtime.telemetry import spans
    for k, v in CACHES.items():
        os.environ.setdefault(k, str(ROOT / v))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    OUT.mkdir(exist_ok=True)
    stem = OUT / f"{args.workload}.{args.seed}"
    kept = {}
    real_read = trace.Tracer._read

    def read(self):
        path = f"{stem}.trace.json"
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            kept["trace"] = json.load(f)
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        os.unlink(path)
        kept["stretch"] = (int(self.t0 * 1e9),
                           int((self.t0 + self.window_s) * 1e9))
        real_read(self)
    trace.Tracer._read = read
    got = run_cell(find_cell(args.workload), args.seed, args.seconds, 1,
                   device)
    program = spans(*kept["stretch"])
    kernels, gaps, worst_us = analyse(kept.pop("trace"),
                                      {s.name for s in program}, program)
    cost = span_cost(device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = got["result"]
    rec = {"card": card.strip(), "workload": args.workload,
           "seed": args.seed, "correct": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "device": res["device"], "breakdown": res.get("breakdown"),
           "spans": by_root(program), "n_spans": len(program),
           "kernels": kernels, "idle_gaps": gaps,
           "clock": {"worst_us": worst_us}, "cost": cost}
    with open(f"{stem}.spans.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("card", "correct", "metrics",
                                          "clock", "cost", "idle_gaps")},
                     indent=1))
    for r in ROOTS:
        o = rec["spans"][r]
        print(r, round(o["ms"], 3), "ms over", o["units"],
              {k: round(v["ms"], 3) for k, v in o["under"].items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
