"""Multi-pod dry run (port of `repro.launch.dryrun`).

For every (architecture x live input shape) cell, on the single-pod
(16,16) mesh and the multi-pod (2,16,16) mesh: open a process group of
torch's fake backend with 256 or 512 ranks (`launch.mesh`), build the
step on a DeviceMesh (`launch.steps.build`) under a `FakeTensorMode`,
make its sharded inputs as fake DTensors, and run it once under the
analyzer (`launch.hlo_analysis`), which sees one rank's local operations
and the collectives DTensor makes. No array is allocated and no
collective moves data; the products are that rank's program and its
analyses, in the reference's JSON record.

Record fields that differ in how they are obtained:
  lower_s            building the bundle: the model and its placed fake
                     weights, the placements of every input and output,
                     and the fake inputs (the reference: jit lowering)
  compile_s          the fake run of the step under the analyzer (the
                     reference: XLA compilation)
  memory_analysis    per device: arguments = the local shards of the
                     step's inputs and of the weights it reads; outputs =
                     the local shards of what it returns; temp = the peak
                     of live bytes the run allocates (its outputs
                     included); alias = the donated bytes (the train
                     state, the decode cache)
  peak_bytes_per_device = arguments + temp: the port builds the new train
                     state beside the old one and writes the decode cache
                     in place, so no aliased buffer is counted twice
                     (the reference subtracts XLA's alias bytes)
The reference's `xla_cost_analysis` and `hlo_bytes` (XLA's own cost
analysis and the HLO text's length) have no counterpart and are left out.
The port's flash entry always skips the key tiles no query sees, so every
record says `block_skip: true` and there is no `--block-skip` flag (the
reference's flag chooses between two kernels).

Every family runs on the mesh, so `--all` writes 66 records (33 live
cells on each mesh). The MoE FFN takes the reference's small-T path for
up to `models.moe.SMALL_T` tokens; `--baseline` sets that to 0 for the
cell (the reference's REPRO_MOE_SMALL_T=0) and puts it back after. On a
CPU mesh DTensor runs an all-to-all as an all-gather plus a chunk; the
analyzer counts each such call as the all-to-all an nccl group runs,
and the `[ok]` line prints how many there were (`a2a fallbacks`).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape prefill_32k --multi-pod
"""
import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             microbatches=1, moment_dtype="float32",
             baseline=False, stats=None) -> dict:
    """The record of one cell; `stats`, if given, gains the run's
    "alltoall_fallbacks" and "wall_s"."""
    from repro_torch.models import moe
    small_t = moe.SMALL_T
    if baseline:
        moe.SMALL_T = 0
    try:
        return _run_cell(arch, shape_name, multi_pod, microbatches,
                         moment_dtype, baseline, stats)
    finally:
        moe.SMALL_T = small_t


def _run_cell(arch, shape_name, multi_pod, microbatches, moment_dtype,
              baseline, stats):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import hlo_analysis, roofline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import fake_group, make_production_mesh, \
        n_chips, production_shape

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules_kind = None
    if baseline:
        # paper-faithful baseline: plain layouts, no sequence-parallel
        # attention, the train rules everywhere
        cfg = dataclasses.replace(cfg, attn_seqpar=False)
        rules_kind = "train"
    sizes, _ = production_shape(multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in sizes),
           "multi_pod": multi_pod, "kind": shape.kind,
           "baseline": baseline,
           "block_skip": True, "microbatches": microbatches}
    with fake_group(torch.Size(sizes).numel()):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with FakeTensorMode():
            t0 = time.time()
            bundle = steps_mod.build(cfg, mesh, shape,
                                     microbatches=microbatches,
                                     moment_dtype=_MOMENT_DTYPES[moment_dtype],
                                     rules_kind=rules_kind)
            args = bundle.inputs()
            t1 = time.time()
            with hlo_analysis.Analyzer() as analyzer:
                out = bundle.fn(*args)
            an, temp = analyzer.result(), analyzer.peak_live_bytes
            t2 = time.time()
            mem = {
                "argument_bytes_per_device": steps_mod.local_bytes(
                    [list(args), bundle.weights()]),
                "output_bytes_per_device": steps_mod.local_bytes(out),
                "temp_bytes_per_device": temp,
                "alias_bytes_per_device": steps_mod.local_bytes(
                    [args[i] for i in bundle.donate_argnums]),
            }
        chips = n_chips(mesh)
    mf = roofline.model_flops_for(cfg, shape)
    rl = roofline.derive(an, n_chips=chips, model_flops=mf)
    rec.update({
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "memory_analysis": mem,
        "hlo_analysis": an,
        "roofline": rl.as_dict(),
    })
    rec["peak_bytes_per_device"] = (mem["argument_bytes_per_device"]
                                    + mem["temp_bytes_per_device"])
    rec["fits_16g_hbm"] = rec["peak_bytes_per_device"] < 16 * 1024 ** 3
    if stats is not None:
        stats["alltoall_fallbacks"] = analyzer.alltoall_fallbacks
        stats["wall_s"] = time.time() - t0
    return rec


def live_cells():
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful layouts; no beyond-paper opts")
    args = ap.parse_args(argv)

    cells = list(live_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    ok = fail = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod512' if mp else 'pod256'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                ok += 1
                continue
            try:
                stats = {}
                rec = run_cell(arch, shape, mp,
                               microbatches=args.microbatches,
                               moment_dtype=args.moment_dtype,
                               baseline=args.baseline, stats=stats)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                rl = rec["roofline"]
                print(f"[ok] {tag}: compile={rec['compile_s']}s "
                      f"bottleneck={rl['bottleneck']} "
                      f"step={rl['step_time_s']:.4f}s "
                      f"mfu={rl['mfu']:.3f} peak_dev_gb="
                      f"{rec['peak_bytes_per_device']/2**30:.2f} "
                      f"a2a fallbacks={stats['alltoall_fallbacks']} "
                      f"wall={stats['wall_s']:.1f}s")
                ok += 1
            except Exception as e:
                fail += 1
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    print(f"dryrun: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
