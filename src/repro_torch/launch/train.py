"""Training launcher (port of `repro.launch.train`), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --shape train_4k --steps 1000 --ckpt-dir build/run1 \\
        [--microbatches 4] [--reduced] [--device cpu]

Runs on the card unless `--device cpu` is given. `--reduced` trains the
family's reduced config in float32 at seq_len <= 128 and global batch
<= 8 (a CPU bring-up run). Restarting the same command resumes from the
newest committed checkpoint in --ckpt-dir, on whichever device it runs.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
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
    from repro_torch.training import TrainConfig, Trainer

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), name=cfg.name,
                                  dtype="float32")
        shape = ShapeConfig(shape.name, min(shape.seq_len, 128),
                            min(shape.global_batch, 8), shape.kind)
    tr = Trainer(cfg, shape,
                 TrainConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir, seed=args.seed,
                             microbatches=args.microbatches,
                             device=args.device))
    state, hist = tr.run()
    if hist:
        print(f"done: step {hist[-1]['step']} loss {hist[-1]['loss']:.4f}; "
              f"stats {tr.stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
