"""The train step (port of `repro.launch.steps`, its train part):
`build_train` composes a `Model`, the config's optimizer and schedule
into `train_step(state, batch) -> (state, metrics)`.

State: {"params": the float32 master as the reference's stacked tree
(`interop.param_tree`), "opt": the optimizer's state of the same shapes,
"step": a 0-d int32 tensor}; batch: a dict of tensors of
`batch_specs`'s shapes on the state's device. The step casts the master
to each leaf's working dtype (`interop.param_dtypes`), takes the loss
and its float32 gradient with respect to the master (with `microbatches`
> 1 the batch is split along its first axis, the gradients summed in
order and divided by the count, as are the loss and the metrics), and
applies the optimizer update. A non-finite loss or gradient norm keeps
the old parameters and moments (a `torch.where` on the device, no host
sync); the step count advances either way. Metrics: "loss", "ce",
"aux", "grad_norm", "lr", 0-d float32 tensors.

The prefill and decode builders, mesh.py, sharding.py and
hlo_analysis.py are XLA mesh code; on one card the serving engine takes
their place, and the rest of `launch/` waits for ROADMAP Queue 1 item
13d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import interop
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map

F32 = torch.float32


def make_schedule_for(cfg, total_steps=10000):
    """The config's schedule at peak lr 3e-4 with 1% warmup."""
    return make_schedule(cfg.schedule, peak_lr=3e-4,
                         warmup_steps=max(1, total_steps // 100),
                         total_steps=total_steps)


def batch_specs(cfg, shape) -> dict:
    """{name: (shape, dtype)} of one host batch of this (arch, shape):
    "tokens" and "labels" int32 (B, S), cut to S - n_patches for the vlm
    family with its "patches" (B, P, d), and the audio family's "frames"
    (B, F, d), float32 as the data pipeline makes them."""
    GB, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if cfg.family == "vlm":
        st = S - cfg.n_patches
        return {"tokens": ((GB, st), i32), "labels": ((GB, st), i32),
                "patches": ((GB, cfg.n_patches, cfg.d_model), f32)}
    out = {"tokens": ((GB, S), i32), "labels": ((GB, S), i32)}
    if cfg.family == "audio":
        out["frames"] = ((GB, cfg.enc_frames, cfg.d_model), f32)
    return out


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclass
class TrainBundle:
    step: Callable           # train_step(state, batch) -> (state, metrics)
    model: Model             # on the meta device: structure only
    opt: object              # the optimizer
    dtypes: dict             # working dtype of every parameter leaf

    def init_state(self, model: Model) -> dict:
        """The training state of a model's weights: the float32 master,
        the optimizer's zero state, step 0, on the model's device."""
        master = interop.param_tree(model, F32)
        dev = model.device
        return {"params": master, "opt": self.opt.init(master),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def state_like(self) -> dict:
        """The state's shapes and dtypes, as meta tensors."""
        return self.init_state(self.model)


def build_train(cfg, *, microbatches=1, total_steps=10000,
                moment_dtype=F32) -> TrainBundle:
    model = Model(cfg, device="meta")
    opt = make_optimizer(cfg, make_schedule_for(cfg, total_steps),
                         moment_dtype=moment_dtype)
    dtypes = interop.param_dtypes(cfg)

    def grads_of(master, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), master)
        p = tree_map(lambda t, dt: t.to(dt), leaves, dtypes)
        loss, met = model.loss(batch, params=p)
        # a weight the loss does not reach gets zeros, as under jax.grad
        g = torch.autograd.grad(loss, tree_leaves(leaves),
                                materialize_grads=True)
        it = iter(g)
        return loss.detach(), {k: v.detach() for k, v in met.items()}, \
            tree_map(lambda _: next(it), leaves)

    def train_step(state, batch):
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch of {B} does not split into "
                                 f"{microbatches} microbatches")
            b = B // microbatches
            grads = loss = met = None
            for i in range(microbatches):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l, m, g = grads_of(state["params"], mb)
                if grads is None:
                    grads, loss, met = g, l, m
                else:
                    tree_map(lambda a, x: a.add_(x), grads, g)
                    loss = loss + l
                    met = {k: met[k] + m[k] for k in met}
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            met = {k: v / microbatches for k, v in met.items()}
        else:
            loss, met, grads = grads_of(state["params"], batch)
        with torch.no_grad():
            newp, newopt, stats = opt.update(grads, state["opt"],
                                             state["params"], state["step"])
            del grads
            good = torch.isfinite(loss) & torch.isfinite(stats["grad_norm"])
            sel = lambda a, b: tree_map(  # noqa: E731
                lambda x, y: torch.where(good, x, y), a, b)
            newp = sel(newp, state["params"])
            newopt = sel(newopt, state["opt"])
        metrics = {"loss": loss, "ce": met["ce"], "aux": met["aux"],
                   "grad_norm": stats["grad_norm"], "lr": stats["lr"]}
        return {"params": newp, "opt": newopt,
                "step": state["step"] + 1}, metrics

    return TrainBundle(train_step, model, opt, dtypes)

