"""The control and the faults of the correctness check, run on the card
at a serve cell's own size on several seeds when its limits are set
(never by benchmark runs).

    python3 perfbench/tools/control.py --workload W --seeds 1,2,3 \
        --seconds 20

Per seed, the cell's program serves its mix for `seconds` at the cell's
rate; then, over the sample a run compares, the served-token gaps
(`drivers.serve.gaps`: widest, trimmed mean, count) of the program; of
the control, the tokens the fp8 reference (`reference.common.mm`,
precision "fp8") puts first; of a witness of bf16 rounding alone, the
reference with its products' operands and its router's input in bf16;
and of the fault "a token altered where it is produced", every served
token plus one, with the smallest and the 1st and 5th percentiles of its
gaps (how a single altered token reads). Each seed prints one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

import torch  # noqa: E402

from perfbench.harness import traffic as tr  # noqa: E402
from perfbench.harness.common import find_cell  # noqa: E402


def serve_readings(cell, seed, seconds, device, override=None):
    """{"program", "control", "bf16", "altered"}: the gaps of one seed."""
    from perfbench.drivers import serve
    sv = serve.Served(cell, seed, device, override)
    reqs = tr.serve_schedule(sv.mix, seed, seconds, sv.c["vocab_size"])
    _, ctx, loop = sv.window(reqs, seconds)
    sample = tr.check_sample(reqs, sv.mix, seed)
    served = {i: list(loop.live[i].out_tokens) for i in sample}
    sv.engine = sv.model = sv.spans = loop = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    args = (sv.ref, sv.c, sv.weights, reqs, served, device)
    alt = serve.token_gaps(*args, "altered")
    q = torch.quantile(alt, torch.tensor([0.01, 0.05], device=alt.device))
    return {"program": serve.gaps(*args), "control": serve.gaps(*args, "fp8"),
            "bf16": serve.gaps(*args, "bf16"),
            "altered": serve.summary(alt),
            "altered_least": [float(alt.min()), *map(float, q)]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    a = ap.parse_args()
    cell = find_cell(a.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        out = serve_readings(cell, seed, a.seconds, dev)
        print(json.dumps({"workload": a.workload, "seed": seed, **out,
                          "wall_s": time.perf_counter() - t}), flush=True)
        gc.collect()        # the model's wrapped methods hold a cycle
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
