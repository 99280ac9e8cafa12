"""The command line of `perfbench/run.py`: one run of one cell.

`--trace 0` prints the cell's end-to-end metrics (host clock), `--trace
1` its per-layer metrics (each read by its reader in
`perfbench/metrics/`; a reader that finds nothing leaves its metric out)
with the device's busy and traced seconds and a breakdown. Both check
the timed path's output against the plain reference (`correct`).
"""
from __future__ import annotations

import argparse
import math
import os
import sys

from perfbench.harness.common import ROOT, device_info, driver, emit, \
    find_cell, forbidden_loaded, reader

# every build or kernel cache the program or torch may write, at fixed
# paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton_cache",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed, seconds, trace, device, override=None) -> dict:
    """Drive one run of `cell` on `device` and return its result dict and
    checks (nothing printed): the part of a run below the look for a
    card, which tests call on the CPU."""
    metrics, checks, extra = driver(cell.traffic["kind"]).run(
        cell, seed, seconds, bool(trace), device, override)
    if trace:
        ctx = dict(extra["ctx"], cell=cell.name)
        out = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = dict(metrics, setup_s=extra["setup_s"])
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        out = {k: {"value": float(metrics[k]), "unit": units[k]}
               for k in units}
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(extra["peak"])
    if trace and "busy_s" in extra:
        dev["busy_s"] = extra["busy_s"]
        dev["window_s"] = extra["window_s"]
    result = {"correct": all(c.ok for c in checks),
              "attempted": extra["attempted"], "failed": extra["failed"],
              "metrics": out, "device": dev}
    if trace and "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    return {"result": result, "checks": checks,
            "readings": extra.get("readings", {})}


def main(argv) -> int:
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ.setdefault(k, str(ROOT / v))
    import torch
    cell = find_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {cell.name} needs {chips} NVIDIA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    got = run_cell(cell, args.seed, args.seconds, args.trace, device)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: modules of the JAX stack or package loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    emit(got["result"], got["checks"], readings=got["readings"])
    return 0
