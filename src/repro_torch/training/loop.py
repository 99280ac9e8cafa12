"""Fault-tolerant training loop (port of `repro.training.loop`), on one
device or on a DeviceMesh.

  * checkpoint/restart: an async step-atomic checkpoint every
    `ckpt_every` steps and a final one (when the last step is itself a
    multiple of `ckpt_every`, the final checkpoint is that async save,
    waited for, not the same step written again as in the reference); on
    (re)start the loop restores the newest committed step and the data
    stream resumes at that cursor (batch = f(seed, step)), so a killed
    and relaunched run reproduces the uninterrupted one bit for bit on
    the same device or mesh (the card's train step sums in a fixed
    order: see `models.common.embed`);
  * preemption: SIGTERM (and the test hook `preempt_at`) makes a
    synchronous checkpoint, then the run returns; under a mesh the ranks
    agree on it before every step (one all-reduce of a flag), so every
    rank takes part in the checkpoint or none does;
  * elastic restore: the newest step is restored onto the trainer's mesh
    with the placements its rules give (`checkpoint.ckpt`), whatever
    mesh, or none, wrote it; with no mesh, onto `device` (card <-> CPU);
  * stragglers: steps slower than `straggler_factor` x the step-time
    EWMA (after the first 5 steps of a run) are counted and logged;
  * NaN/overflow guard: the step keeps the old state on a non-finite
    loss or gradient norm (inside the step); the loop counts such steps
    and raises after `max_bad_steps`.

`Trainer(cfg, mesh, shape, tcfg)` takes the reference's arguments. With
`mesh=None` the step is `launch.steps.build_train`'s on `tcfg.device`;
with a mesh it is `launch.steps.build(cfg, mesh, shape)`'s: the master
and moments are DTensors, every rank draws the same batch at the same
cursor and keeps its shard of it (`steps.batch_placements`), and every
rank makes the same calls (the mesh's device type must be
`tcfg.device`'s; on the card each rank uses its current CUDA device).

State init: the `Model`'s seeded init (a `torch.Generator` on the device
seeded with `seed`) in the working dtype, cast to the float32 master;
under a mesh every rank makes the whole state and keeps its shards, so
the mesh and the no-mesh runs start from the same numbers.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_batch_iterator
from repro_torch.launch import steps as steps_mod
from repro_torch.models.common import is_dtensor
from repro_torch.models.model import Model


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/repro_torch_ckpt"
    keep_last: int = 3
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    straggler_factor: float = 3.0
    max_bad_steps: int = 10
    preempt_at: Optional[int] = None     # test hook: simulate SIGTERM
    log_fn: Callable = print
    telemetry: Optional[object] = None   # runtime.TelemetryCollector
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg, mesh, shape, tcfg: TrainConfig):
        self.cfg, self.mesh, self.shape, self.tcfg = cfg, mesh, shape, tcfg
        if mesh is None:
            self.device = torch.device(tcfg.device)
            self.bundle = steps_mod.build_train(
                cfg, microbatches=tcfg.microbatches,
                total_steps=tcfg.total_steps)
            self.train = self.bundle
            self.step_fn = self.bundle.step
        else:
            if torch.device(tcfg.device).type != mesh.device_type:
                raise ValueError(f"a {mesh.device_type} mesh with device "
                                 f"{tcfg.device!r}")
            self.device = torch.device(mesh.device_type)
            if mesh.device_type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self.bundle = steps_mod.build(cfg, mesh, shape,
                                          microbatches=tcfg.microbatches,
                                          total_steps=tcfg.total_steps)
            self.train = self.bundle.meta["train"]
            self.step_fn = self.bundle.fn
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_last=tcfg.keep_last)
        self._preempted = False
        self.stats = {"straggler_steps": 0, "bad_steps": 0,
                      "restored_step": None}

    # -- state ------------------------------------------------------------
    def init_state(self):
        model = Model(self.cfg, device=self.device, seed=self.tcfg.seed)
        state = self.train.init_state(model)
        del model
        return state

    def restore_or_init(self):
        if self.mesh is None:
            step, state = self.ckpt.restore_latest(self.train.state_like(),
                                                   device=self.device)
        else:
            step, state = self.ckpt.restore_latest(
                self.bundle.in_specs[0], mesh=self.mesh,
                shardings=self.bundle.in_placements[0])
        if state is None:
            return self.init_state(), 0
        self.stats["restored_step"] = step
        return state, step

    def _batch(self, host: dict) -> dict:
        """A host batch on the device; under a mesh, each rank's shard."""
        batch = steps_mod.to_device(host, self.device)
        if self.mesh is None:
            return batch
        return steps_mod.place_tree(batch, self.bundle.in_placements[1],
                                    self.mesh)

    def _agreed(self, flag: bool) -> bool:
        """`flag` on any rank of the mesh (itself with no mesh)."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # -- loop -------------------------------------------------------------
    def _install_sigterm(self):
        """Set the SIGTERM handler that asks for a preemption checkpoint;
        returns the handler it replaced (None off the main thread)."""
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not the main thread

    def run(self):
        """Train to `total_steps` (or a preemption); the caller's SIGTERM
        handler is back in place on every exit."""
        previous = self._install_sigterm()
        try:
            return self._run()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self):
        tc = self.tcfg
        state, start = self.restore_or_init()
        _, it = make_batch_iterator(self.cfg, self.shape, seed=tc.seed,
                                    start_step=start)
        ewma = None
        history = []
        step = start
        last_async = None
        while step < tc.total_steps:
            if tc.preempt_at is not None and step == tc.preempt_at:
                self._preempted = True
            if self._agreed(self._preempted):
                self._preempted = True
                self.ckpt.save(step, state)
                tc.log_fn(f"[preempt] checkpointed at step {step}, exiting")
                return state, history

            batch = self._batch(next(it))
            t0 = time.time()
            new_state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v.full_tensor() if is_dtensor(v) else v)
                       for k, v in metrics.items()}
            dt = time.time() - t0

            state = new_state  # the in-step guard made a bad update a no-op
            if not np.isfinite(metrics["loss"]):
                self.stats["bad_steps"] += 1
                tc.log_fn(f"[warn] non-finite loss at step {step}; "
                          f"update skipped")
                if self.stats["bad_steps"] > tc.max_bad_steps:
                    raise RuntimeError("too many bad steps")

            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > tc.straggler_factor * ewma and step > start + 5:
                self.stats["straggler_steps"] += 1
                tc.log_fn(f"[straggler] step {step} took {dt:.3f}s "
                          f"(ewma {ewma:.3f}s)")
            history.append({"step": step, **metrics, "time_s": dt})
            if tc.telemetry is not None:
                tc.telemetry.on_train_step(
                    step, self.shape.global_batch * self.shape.seq_len, dt,
                    metrics["loss"])
            if step % tc.log_every == 0:
                tc.log_fn(f"step {step}: loss={metrics['loss']:.4f} "
                          f"lr={metrics['lr']:.2e} "
                          f"gnorm={metrics['grad_norm']:.3f} {dt:.2f}s")
            step += 1
            if step % tc.ckpt_every == 0:
                self.ckpt.save_async(step, state)
                last_async = step

        if last_async == step:
            self.ckpt.wait()        # the final state is already being saved
        else:
            self.ckpt.save(step, state)
        return state, history
