"""Training launcher (port of `repro.launch.train`), on one device or on a
DeviceMesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --shape train_4k --steps 1000 --ckpt-dir build/run1 \\
        [--mesh 16x16 | --mesh 2x16x16] [--microbatches 4] [--reduced] \\
        [--device cpu]

    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \\
        --arch llama3.2-1b --reduced --mesh 2x1 --device cpu --steps 3

Runs on the card unless `--device cpu` is given. A single process with
no `--mesh` trains without a mesh (the reference's default on one
device). With `--mesh`, or under `torchrun` (`WORLD_SIZE` > 1), every
process opens the default process group (nccl on the card, each rank on
its `LOCAL_RANK`'s device; gloo with `--device cpu`; `torchrun`'s
address, or a free port on localhost for a single process) and trains
on the mesh: `--mesh AxB` is ("data", "model"), `AxBxC` ("pod", "data",
"model"), `A` ("data",), and without `--mesh` every rank is 'data'. A
mesh whose size is not the world size raises. `--reduced` trains the
family's reduced config in float32 at seq_len <= 128 and global batch
<= 8 (a CPU bring-up run). Restarting the same command resumes from the
newest committed checkpoint in --ckpt-dir, on whichever device or mesh
it runs (rank 0 writes it; every rank reads it).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket

AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_shape(spec: str) -> tuple:
    """(sizes, axis names) of a `--mesh` spec such as "16x16"."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in AXES:
        raise ValueError(f"--mesh {spec!r}: one to three sizes")
    return dims, AXES[len(dims)]


def parse_mesh(spec: str, device_type: str = "cpu"):
    """The DeviceMesh of a `--mesh` spec over the open default group."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*mesh_shape(spec), device_type=device_type)


def _open_group(world: int, device: str) -> int:
    """Open the default group of this process's rank; returns the rank."""
    import torch

    from repro_torch.launch.mesh import open_group
    rank = int(os.environ.get("RANK", "0"))
    if device != "cpu":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "MASTER_ADDR" in os.environ:
        init = "env://"
    else:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            init = f"tcp://localhost:{sock.getsockname()[1]}"
    open_group(world, backend="gloo" if device == "cpu" else "nccl",
               rank=rank, init_method=init)
    return rank


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 16x16 or 2x16x16; under torchrun the "
                         "default is every rank as 'data'")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU bring-up)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch.mesh import close_group, make_mesh
    from repro_torch.training import TrainConfig, Trainer

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), name=cfg.name,
                                  dtype="float32")
        shape = ShapeConfig(shape.name, min(shape.seq_len, 128),
                            min(shape.global_batch, 8), shape.kind)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    meshed = args.mesh is not None or world > 1
    rank = _open_group(world, args.device) if meshed else 0
    try:
        dev_type = "cpu" if args.device == "cpu" else "cuda"
        mesh = None
        if args.mesh:
            mesh = parse_mesh(args.mesh, dev_type)
        elif meshed:
            mesh = make_mesh((world,), AXES[1], dev_type)
        tr = Trainer(cfg, mesh, shape,
                     TrainConfig(total_steps=args.steps,
                                 ckpt_every=args.ckpt_every,
                                 ckpt_dir=args.ckpt_dir, seed=args.seed,
                                 microbatches=args.microbatches,
                                 device=args.device,
                                 log_fn=print if rank == 0
                                 else lambda *a: None))
        state, hist = tr.run()
        if hist and rank == 0:
            where = "" if mesh is None else \
                f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            print(f"done: step {hist[-1]['step']} loss "
                  f"{hist[-1]['loss']:.4f} on {tr.device}{where}; stats "
                  f"{tr.stats}")
    finally:
        if meshed:
            close_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
