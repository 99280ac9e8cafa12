#!/usr/bin/env python3
"""Where the time of the port's main path goes on the card.

Runs `characterize` over the default 96-point lattice (f64) once to warm
up, then once under `torch.profiler` with CPU and CUDA activities, and
reports the device time by kernel name (device-side events only, so a
host op and the kernels it launched are not counted twice), the fused
Newton scan kernel's rows on their own, the wall time, and the device's
busy and idle shares (busy = summed kernel time / wall time; the path
runs on one stream, so kernels do not overlap).

Then it takes one topology group apart the way `_characterize_group`
runs it: `group_inputs` (host netlist and stamp assembly), `precompute`,
the source term (`src_sequence`, K @ src, `pack_params`), the scan
(`ops.fused_newton_scan`) and `crossing_time`. Each stage is timed on
the host between synchronizes in an unprofiled pass, with CUDA events
around it (the span the device saw, idle gaps included); its device
time is taken from a profiler session of its own in a second pass (each
stage runs again until a session records device time, at most three
times; every stage launches at least a copy).

Prints a summary and writes the full tables to
chiprun_out/profile_characterize.json. Needs a CUDA device; exits
nonzero without one.

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
N_STEPS = 300
SCAN_KERNEL = "fused_newton_kernel"


def device_rows(prof) -> list:
    """Device time by kernel name from a finished profiler session."""
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
    return rows


def group_stages(cfgs):
    """The stages of `_characterize_group` for the lattice's first
    topology group, as (name, fn) pairs; each fn takes the previous
    stages' results in a dict and adds its own."""
    from repro_torch.core.bank import build_bank
    from repro_torch.core.dse_batch import group_by_topology
    from repro_torch.core.spice.char_batch import group_inputs
    from repro_torch.core.spice.transient import crossing_time
    from repro_torch.kernels.batched_solve import newton as nwt
    from repro_torch.kernels.batched_solve import ops
    from repro_torch.kernels.batched_solve.sparse import pack_params

    idx = next(iter(group_by_topology(cfgs).values()))
    group = [cfgs[i] for i in idx]
    banks = [build_bank(c) for c in group]
    f64 = dict(dtype=torch.float64, device="cuda")

    def inputs(s):
        s["inp"] = inp = group_inputs(group, banks, n_seg=8, n_steps=N_STEPS,
                                      device="cuda")
        s["tr"] = inp["tr"]
        s["te"] = torch.as_tensor(inp["t_end"], **f64)

    def precompute(s):
        s["pre"] = nwt.precompute(s["tr"].spec, s["inp"]["over"]["G"],
                                  s["inp"]["over"]["C"], s["te"] / N_STEPS)

    def source(s):
        tr, te, inp = s["tr"], s["te"], s["inp"]
        src = tr.src_sequence(te, torch.as_tensor(inp["wt"], **f64),
                              torch.as_tensor(inp["wv"], **f64), N_STEPS)
        s["Ksrc"] = torch.einsum("bij,btj->tbi", s["pre"]["K"],
                                 src).contiguous()
        sdt, _ = tr.spec.dtypes
        B = te.shape[0]
        s["params"] = pack_params(tr.system.dev, B, sdt, {})
        s["v0"] = inp["v0"].to(sdt).expand(B, tr.spec.n).contiguous()

    def scan(s):
        tr = s["tr"]
        s["vs"] = ops.fused_newton_scan(tr.spec, s["pre"], s["Ksrc"],
                                        s["params"], s["v0"], iters=tr.iters,
                                        tol=tr.tol)

    def crossing(s):
        tr, inp, te = s["tr"], s["inp"], s["te"]
        t = torch.arange(1, N_STEPS + 1, **f64)[None, :] \
            * (te[:, None] / N_STEPS)
        probe = s["vs"][..., tr.system.probes["rbl_near"] - 1]
        swing = group[0].tech.v_sense_se
        rising = banks[0].cell.predischarge
        target = inp["v_pre"] + (swing if rising else -swing)
        tc, valid = crossing_time(t, probe, target, rising=rising)
        s["tc"] = (tc.cpu().numpy(), valid.cpu().numpy())

    return [("group_inputs", inputs), ("precompute", precompute),
            ("source term", source), ("scan", scan),
            ("crossing_time", crossing)]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_characterize: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.spice.char_batch import characterize
    from repro_torch.kernels.batched_solve import fused

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cfgs = lattice_configs()
    characterize(cfgs, device="cuda")
    torch.cuda.synchronize()
    fused.fused_newton_scan.launches = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        characterize(cfgs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r["device_ms"] for r in rows)
    scan_rows = [r for r in rows if SCAN_KERNEL in r["name"]]
    out = {"card": card, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall * 1e3),
           "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "scan_launches": fused.fused_newton_scan.launches,
           "scan_kernels": scan_rows, "kernels": rows}
    print(f"card: {card}")
    print(f"characterize 96 points f64 under the profiler: wall "
          f"{out['wall_ms']!r} ms, device busy {busy_ms!r} ms, idle share "
          f"{out['device_idle_share']!r}")
    print(f"fused_newton_scan launches {out['scan_launches']}; scan kernel "
          f"rows:")
    for r in scan_rows:
        print(f"  {r['device_ms']!r:>24} ms  x{r['count']:<6} "
              f"({r['device_ms'] / r['count']!r} ms each) {r['name'][:80]}")
    print("largest device items:")
    for r in rows[:12]:
        print(f"  {r['device_ms']!r:>24} ms  x{r['count']:<6} {r['name'][:90]}")

    # one group, stage by stage: host time unprofiled, then device time
    stages = group_stages(cfgs)
    state: dict = {}
    for _, fn in stages:           # warm
        fn(state)
    torch.cuda.synchronize()
    host_ms, span_ms, device_ms = {}, {}, {}
    state = {}
    for name, fn in stages:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn(state)
        end.record()
        torch.cuda.synchronize()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        span_ms[name] = start.elapsed_time(end)
    state = {}
    for name, fn in stages:
        # a short session now and then records none of the kernels that
        # ran in it (one came back without the scan's): try up to three
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=acts) as sprof:
                fn(state)
                torch.cuda.synchronize()
            device_ms[name] = sum(r["device_ms"] for r in device_rows(sprof))
            if device_ms[name] > 0:
                break
    out["group_stages"] = [{"stage": name, "host_ms": host_ms[name],
                            "span_ms": span_ms[name],
                            "device_ms": device_ms[name]}
                           for name, _ in stages]
    print("one topology group (16 lanes, 300 steps), stage by stage "
          "(host ms between synchronizes; span ms between CUDA events "
          "around the stage; device ms from the profiler):")
    for row in out["group_stages"]:
        print(f"  {row['stage']:<14} host {row['host_ms']!r} ms, span "
              f"{row['span_ms']!r} ms, device {row['device_ms']!r} ms")
    print(f"  sum: host {sum(host_ms.values())!r} ms, device "
          f"{sum(device_ms.values())!r} ms [{card}]")

    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_characterize.json").write_text(json.dumps(out, indent=1))
    return 0 if rows and scan_rows and out["scan_launches"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
