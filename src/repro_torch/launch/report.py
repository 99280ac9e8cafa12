"""Render the dry run's §Dry-run / §Roofline tables from the records
`launch.dryrun` writes (port of `repro.launch.report`, the same tables).

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun
"""
from __future__ import annotations

import glob
import json
import sys


def load(results_dir: str):
    recs = []
    for p in sorted(glob.glob(f"{results_dir}/*.json")):
        recs.append(json.load(open(p)))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def roofline_table(recs, mesh="16x16") -> str:
    rows = [
        "| arch | shape | kind | compute s | memory s | collective s | "
        "bottleneck | MODEL_FLOPS | useful/HLO | MFU bound | peak GiB/dev | fits 16G |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        rl = r["roofline"]
        an = r["hlo_analysis"]
        useful = rl["model_flops"] / max(rl["hlo_flops_global"], 1.0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {rl['compute_s']:.4g} | {rl['memory_s']:.4g} "
            f"| {rl['collective_s']:.4g} | **{rl['bottleneck']}** "
            f"| {rl['model_flops']:.3g} | {useful:.3f} "
            f"| {rl['mfu']:.4f} | {fmt_bytes(r['peak_bytes_per_device'])} "
            f"| {'Y' if r['fits_16g_hbm'] else 'N'} |")
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    rows = [
        "| arch | shape | mesh | compile s | flops/dev | HLO bytes/dev | "
        "wire bytes/dev | collectives (AR/AG/RS/A2A/CP) | args GiB | temp GiB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        an = r["hlo_analysis"]
        bt = an["collective_by_type"]
        coll = "/".join(f"{bt.get(k, 0)/2**20:.0f}M" for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"))
        ma = r["memory_analysis"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compile_s']} "
            f"| {an['flops']:.3g} | {an['mem_bytes']:.3g} "
            f"| {an['collective_wire_bytes']:.3g} | {coll} "
            f"| {fmt_bytes(ma['argument_bytes_per_device'])} "
            f"| {fmt_bytes(ma['temp_bytes_per_device'])} |")
    return "\n".join(rows)


def summary(recs) -> str:
    n256 = sum(1 for r in recs if r["mesh"] == "16x16")
    n512 = sum(1 for r in recs if r["mesh"] == "2x16x16")
    worst = sorted((r for r in recs if r["mesh"] == "16x16"),
                   key=lambda r: r["roofline"]["mfu"])[:5]
    coll = sorted((r for r in recs if r["mesh"] == "16x16"),
                  key=lambda r: -r["roofline"]["collective_s"])[:5]
    out = [f"cells compiled: {n256} single-pod + {n512} multi-pod",
           "worst MFU bound: " + ", ".join(
               f"{r['arch']}:{r['shape']}={r['roofline']['mfu']:.4f}"
               for r in worst),
           "most collective-bound: " + ", ".join(
               f"{r['arch']}:{r['shape']}={r['roofline']['collective_s']:.3g}s"
               for r in coll)]
    return "\n".join(out)


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    recs = load(d)
    print("## summary\n" + summary(recs))
    print("\n## §Roofline (single-pod 16x16)\n" + roofline_table(recs))
    print("\n## §Roofline (multi-pod 2x16x16)\n" +
          roofline_table(recs, mesh="2x16x16"))
    print("\n## §Dry-run\n" + dryrun_table(recs))
