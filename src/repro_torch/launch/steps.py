"""Step builders (port of `repro.launch.steps`): compose a `Model`, a
mesh and the config's optimizer into train_step / prefill / decode_step
functions, with the specs (shape, dtype, DTensor placements) of their
inputs: what the dry run runs on fake tensors and what a run on the card
runs on real ones.

Shape kinds (configs/base.SHAPES):
  train    -> train_step(state, batch)  [float32 master + optimizer state]
  prefill  -> prefill(batch)            [the model holds the serving weights]
  decode   -> decode_step(cache, token, pos)

`build_train` (one card, or under `mesh`): state {"params": the float32
master as the reference's stacked tree (`interop.param_tree`), "opt": the
optimizer's state of the same shapes, "step": a 0-d int32 tensor}; batch:
a dict of tensors of `batch_specs`'s shapes on the state's device. The
step casts the master to each leaf's working dtype (`interop.
param_dtypes`), takes the loss and its float32 gradient with respect to
the master (with `microbatches` > 1 the batch is split along its first
axis, the gradients summed in order and divided by the count, as are the
loss and the metrics), and applies the optimizer update. A non-finite
loss or gradient norm keeps the old parameters and moments (a
`torch.where` on the device, no host sync); the step count advances
either way. Metrics: "loss", "ce", "aux", "grad_norm", "lr", 0-d float32
tensors. Under a mesh the master and the moments are DTensors placed by
`param_specs` and `opt.state_specs`, the batch by the rules' batch axes,
and the step runs in the model's sharding context.

`build(cfg, mesh, shape)` is the reference's entry: it returns a
`StepBundle` of the shape's kind on a DeviceMesh (`launch.mesh`). The
prefill bundle's model holds the weights, placed by `param_specs`; its
outputs are (logits, cache, pos), the cache placed by `cache_specs` at
`kv_window(seq_len)`. The decode bundle writes the cache in place (the
reference's donation) and returns (logits, cache).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch import interop
from repro_torch.launch.sharding import Spec, batch_sharding, make_rules, \
    sds, sharding_tree
from repro_torch.models.common import is_dtensor
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map

F32 = torch.float32


def make_schedule_for(cfg, total_steps=10000):
    """The config's schedule at peak lr 3e-4 with 1% warmup."""
    return make_schedule(cfg.schedule, peak_lr=3e-4,
                         warmup_steps=max(1, total_steps // 100),
                         total_steps=total_steps)


def batch_placements(mesh, rules, B: int) -> tuple:
    """Placements of a (B, ...) batch array: batch over the rules' data
    axes when B divides them, else replicated."""
    axes = rules["batch"] or ()
    n = math.prod(dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
                  for a in axes)
    if B % max(n, 1):
        return batch_sharding(mesh, {"batch": None})
    return batch_sharding(mesh, rules)


def batch_specs(cfg, shape, mesh=None, rules=None) -> dict:
    """{name: Spec} of one host batch of this (arch, shape), each a
    (shape, dtype) pair: "tokens" and "labels" int32 (B, S), cut to
    S - n_patches for the vlm family with its "patches" (B, P, d), and the
    audio family's "frames" (B, F, d), float32 as the data pipeline makes
    them. With a mesh, each carries the placements of `batch_placements`."""
    GB, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    pl = batch_placements(mesh, rules, GB) if mesh is not None else None
    if cfg.family == "vlm":
        st = S - cfg.n_patches
        return {"tokens": sds((GB, st), i32, pl),
                "labels": sds((GB, st), i32, pl),
                "patches": sds((GB, cfg.n_patches, cfg.d_model), f32, pl)}
    out = {"tokens": sds((GB, S), i32, pl), "labels": sds((GB, S), i32, pl)}
    if cfg.family == "audio":
        out["frames"] = sds((GB, cfg.enc_frames, cfg.d_model), f32, pl)
    return out


def place(x, placements, mesh):
    """x as a DTensor with `placements` on `mesh`: a DTensor is
    redistributed, a plain tensor (the same on every rank) split locally,
    sending nothing. `placements` None leaves x as it is."""
    if placements is None:
        return x
    if is_dtensor(x):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def place_tree(tree, placements, mesh):
    """`place` over a tree and its tree of placements (None leaves x as
    it is; a tuple of placements is a leaf)."""
    return tree_map(lambda pl, x: place(x, pl, mesh), placements, tree,
                    leaf=lambda pl: pl is None or isinstance(pl, tuple))


def materialize(specs, mesh):
    """Uninitialized tensors for a tree of `Spec`s on the mesh's device
    type, placed (under a FakeTensorMode: fake, nothing allocated)."""
    return tree_map(lambda s: place(torch.empty(
        s.shape, dtype=s.dtype, device=mesh.device_type), s.placements,
        mesh), specs, leaf=lambda s: isinstance(s, Spec))


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors (a DTensor's local
    shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclass
class TrainBundle:
    step: Callable           # train_step(state, batch) -> (state, metrics)
    model: Model             # on the meta device: structure only
    opt: object              # the optimizer
    dtypes: dict             # working dtype of every parameter leaf
    placements: dict = None  # under a mesh: the state's placements

    def init_state(self, model: Model) -> dict:
        """The training state of a model's weights: the float32 master,
        the optimizer's zero state, step 0, on the model's device; under
        a mesh the master and moments placed by `placements`."""
        master = interop.param_tree(model, F32)
        dev = model.device
        state = {"params": master, "opt": self.opt.init(master),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.placements is None:
            return state
        return place_tree(state, self.placements, self.model.mesh)

    def state_like(self) -> dict:
        """The state's shapes and dtypes, as meta tensors."""
        return self.init_state(self.model)


def build_train(cfg, *, microbatches=1, total_steps=10000,
                moment_dtype=F32, mesh=None, rules=None) -> TrainBundle:
    model = Model(cfg, device="meta") if mesh is None else \
        Model(cfg, device="meta", mesh=mesh, rules=rules)
    opt = make_optimizer(cfg, make_schedule_for(cfg, total_steps),
                         moment_dtype=moment_dtype)
    dtypes = interop.param_dtypes(cfg)
    placements = None
    if mesh is not None:
        pspecs = model.param_specs()
        master = interop.param_tree(Model(cfg, device="meta"), F32)
        placements = {
            "params": sharding_tree(pspecs, master, model.rules, mesh),
            "opt": sharding_tree(opt.state_specs(pspecs, master),
                                 opt.init(master), model.rules, mesh),
            "step": None}

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
        with model._ctx():
            return _train_step(state, batch)

    def _train_step(state, batch):
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

    return TrainBundle(train_step, model, opt, dtypes, placements)


# ---------------------------------------------------------------------------
# Bundles on a mesh
# ---------------------------------------------------------------------------

@dataclass
class StepBundle:
    kind: str
    fn: Callable                 # the step; runs in the model's context
    in_specs: tuple              # Specs of fn's arguments, with placements
    in_placements: Any
    out_placements: Any
    donate_argnums: tuple        # arguments the step updates or replaces
    model: Model
    rules: dict
    meta: dict = field(default_factory=dict)

    @property
    def mesh(self):
        return self.model.mesh

    def inputs(self):
        """Arguments of `fn` made from `in_specs`, uninitialized (under a
        FakeTensorMode: fake, nothing allocated)."""
        return materialize(self.in_specs, self.mesh)

    def shard(self, *args):
        """Arguments given as plain tensors, the same on every rank, placed
        as `fn` takes them."""
        return tuple(place_tree(a, pl, self.mesh)
                     for a, pl in zip(args, self.in_placements))

    def weights(self):
        """The tensors the step reads besides its arguments: the model's
        weights (prefill, decode)."""
        return [] if self.kind == "train" else list(self.model.parameters())


def build(cfg, mesh, shape, *, microbatches=1, total_steps=10000,
          moment_dtype=F32, rules_kind=None, seed=0):
    """The `StepBundle` of `shape`'s kind for `cfg` on `mesh`. There is no
    `block_skip`: the port's flash entry always skips the key tiles no
    query sees (the reference's block_skip=True)."""
    rules = make_rules(mesh, batch_size=shape.global_batch,
                       kind=rules_kind or shape.kind)
    if shape.kind == "train":
        return _build_train(cfg, mesh, shape, rules, microbatches,
                            total_steps, moment_dtype)
    model = Model(cfg, device=mesh.device_type, seed=seed, mesh=mesh,
                  rules=rules)
    if shape.kind == "prefill":
        return _build_prefill(cfg, mesh, shape, model, rules)
    return _build_decode(cfg, mesh, shape, model, rules)


def _replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def _cache_placements(model, B, W, rules, mesh):
    shapes = model.init_cache(B, W, device="meta")
    return shapes, sharding_tree(model.cache_specs(), shapes, rules, mesh)


def _build_train(cfg, mesh, shape, rules, microbatches, total_steps,
                 moment_dtype):
    tb = build_train(cfg, microbatches=microbatches, total_steps=total_steps,
                     moment_dtype=moment_dtype, mesh=mesh, rules=rules)
    like = build_train(cfg, total_steps=total_steps,
                       moment_dtype=moment_dtype).state_like()
    state_specs = tree_map(lambda t, pl: sds(t.shape, t.dtype, pl),
                           {"params": like["params"], "opt": like["opt"]},
                           {"params": tb.placements["params"],
                            "opt": tb.placements["opt"]},
                           leaf=lambda t: isinstance(t, torch.Tensor))
    state_specs["step"] = sds((), torch.int32)
    bspecs = batch_specs(cfg, shape, mesh, rules)
    rep = _replicated(mesh)
    in_pl = (tb.placements, {k: s.placements for k, s in bspecs.items()})
    out_pl = (tb.placements, {k: rep for k in ("loss", "ce", "aux",
                                               "grad_norm", "lr")})

    def train_step(state, batch):
        new, metrics = tb.step(state, batch)
        return (place_tree(new, tb.placements, mesh),
                place_tree(metrics, out_pl[1], mesh))

    return StepBundle("train", train_step, (state_specs, bspecs), in_pl,
                      out_pl, (0,), tb.model, rules,
                      dict(opt=tb.opt, train=tb))


def _build_prefill(cfg, mesh, shape, model, rules):
    bspecs = batch_specs(cfg, shape, mesh, rules)
    bspecs.pop("labels")
    W = model.kv_window(shape.seq_len)
    cache_shapes, c_pl = _cache_placements(model, shape.global_batch, W,
                                           rules, mesh)
    rep = _replicated(mesh)
    out_pl = (rep, c_pl, rep)

    def prefill(batch):
        logits, cache, pos = model.prefill(batch, W)
        return (place(logits, rep, mesh), place_tree(cache, c_pl, mesh),
                place(pos, rep, mesh))

    return StepBundle("prefill", prefill, (bspecs,),
                      ({k: s.placements for k, s in bspecs.items()},),
                      out_pl, (), model, rules,
                      dict(cache_shapes=cache_shapes, c_pl=c_pl))


def _build_decode(cfg, mesh, shape, model, rules):
    GB = shape.global_batch
    W = model.kv_window(shape.seq_len)
    cache_shapes, c_pl = _cache_placements(model, GB, W, rules, mesh)
    cache_specs = tree_map(lambda t, pl: sds(t.shape, t.dtype, pl),
                           cache_shapes, c_pl,
                           leaf=lambda t: isinstance(t, torch.Tensor))
    bsh = batch_placements(mesh, rules, GB)

    def decode_step(cache, token, pos):
        logits, cache = model.decode_step(cache, token, pos)
        return place(logits, bsh, mesh), cache

    in_specs = (cache_specs, sds((GB, 1), torch.int32, bsh),
                sds((GB,), torch.int32, bsh))
    return StepBundle("decode", decode_step, in_specs, (c_pl, bsh, bsh),
                      (bsh, c_pl), (0,), model, rules,
                      dict(cache_shapes=cache_shapes, c_pl=c_pl))

