"""Optimizers over trees (nested dicts, lists, tuples) of torch tensors
(port of `repro.optim.optimizers`): AdamW, which the projected-Adam
design optimizer (`optim.dse_opt`) and the trainer run, and Adafactor,
the trainer's for arctic-480b.

AdamW computes in float32 whatever the parameters' dtype, as the
reference does: gradients are clipped by their float32 global norm,
moments are float32 (or `moment_dtype`), the bias corrections use a
float32 step count, and the update is formed in float32 and cast back to
the parameter's dtype. On float64 design knobs this float32 arithmetic
is part of the result: the Adam trajectory, and with it the optimum,
follows it.

Each optimizer exposes:
  init(params)                       -> state tree
  update(grads, state, params, step) -> (new_params, new_state, stats)
  state_specs(param_specs)           -> logical-axis tree matching state

The trainer optimizes the reference's STACKED parameter tree (every
leaf of a layer stack carries the leading layer axis), and two rules
read that axis as the reference does: AdamW decays a leaf iff it has two
or more dimensions, so a stacked (L, d) norm scale is decayed; and
Adafactor's RMS update clip takes its mean over the whole stacked leaf.

Adafactor (Shazeer & Stern) keeps no first moment and factors the second
moment of a leaf whose last two dimensions are both at least
`min_dim_size_to_factor` into row and column means; `step` enters
through beta = 1 - (step + 1)^-decay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

F32 = torch.float32


def tree_leaves(tree, paths=False, leaf=None):
    """The leaves of a tree of nested dicts, lists and tuples in the
    reference's (jax's) order: dict keys sorted, items by index. With
    `paths`, [(path, leaf)], the keys and indices on the way joined by
    "/" ("params/blocks/attn/wq", "step"): the checkpoint's leaf paths.
    `leaf(x)` True makes a node a leaf."""
    out = []

    def walk(t, prefix):
        if leaf is not None and leaf(t):
            out.append((prefix[:-1], t) if paths else t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, f"{prefix}{i}/")
        else:
            out.append((prefix[:-1], t) if paths else t)
    walk(tree, "")
    return out


def tree_map(fn, tree, *rest, leaf=None):
    """`fn` over the leaves of `tree` and the trees of the same structure
    in `rest`, called in `tree_leaves`' order; returns a tree of that
    structure (its dicts' keys sorted). `leaf(x)` True makes a node of
    `tree` a leaf."""
    if leaf is not None and leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), leaf=leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), leaf=leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree):
    """float32 l2 norm over every leaf."""
    return torch.sqrt(sum((g.to(F32) ** 2).sum() for g in tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / gn.clamp_min(1e-9), 1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    state_specs: Callable


def adamw(schedule, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm=1.0, moment_dtype=F32):
    """AdamW over float32 master arithmetic; `step` is an integer (or a
    0-d integer tensor)."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params, step):
        grads, gn = _clip_by_global_norm(grads, max_grad_norm)
        lr = schedule(step)
        t = torch.as_tensor(step, device=gn.device).to(F32) + 1
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t

        def upd(g, mu, nu, p):
            g = g.to(F32)
            mu32 = mu.to(F32) * b1 + (1 - b1) * g
            nu32 = nu.to(F32) * b2 + (1 - b2) * g * g
            step_ = (mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)
            wd = weight_decay * p.to(F32) if p.dim() >= 2 else 0.0
            newp = p.to(F32) - lr * (step_ + wd)
            return (newp.to(p.dtype), mu32.to(moment_dtype),
                    nu32.to(moment_dtype))

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
        return pick(0), {"mu": pick(1), "nu": pick(2)}, \
            {"grad_norm": gn, "lr": lr}

    def state_specs(param_specs, param_shapes=None):
        return {"mu": param_specs, "nu": param_specs}

    return Optimizer(init, update, state_specs)


def adafactor(schedule, *, eps=1e-30, clip_threshold=1.0, decay=0.8,
              max_grad_norm=1.0, min_dim_size_to_factor=128):
    """Adafactor without a first moment: row/column-factored float32
    second moments, memory ~ O(rows + columns) per factored leaf."""

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor \
            and p.shape[-2] >= min_dim_size_to_factor

    def init(params):
        def one(p):
            z = lambda s: torch.zeros(s, dtype=F32, device=p.device)  # noqa
            if _factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"v": tree_map(one, params)}

    def update(grads, state, params, step):
        grads, gn = _clip_by_global_norm(grads, max_grad_norm)
        lr = schedule(step)
        t = torch.as_tensor(step, device=gn.device).to(F32) + 1
        beta = 1.0 - t ** (-decay)

        def upd(p, g, v):
            g = g.to(F32)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                r = vr / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
                u = g * torch.rsqrt(r)[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + (1 - beta) * g2}
                u = g * torch.rsqrt(nv["v"])
            # update clipping by its RMS over the whole (stacked) leaf
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            newp = p.to(F32) - lr * u
            return newp.to(p.dtype), nv

        out = tree_map(upd, params, grads, state["v"])
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
        return pick(0), {"v": pick(1)}, {"grad_norm": gn, "lr": lr}

    def state_specs(param_specs, param_shapes):
        def one(axes, p):
            if _factored(p):
                return {"vr": tuple(axes[:-1]),
                        "vc": tuple(axes[:-2]) + tuple(axes[-1:])}
            return {"v": tuple(axes)}
        return {"v": tree_map(one, param_specs, param_shapes,
                          leaf=lambda x: isinstance(x, tuple) and all(
                              isinstance(e, (str, type(None))) for e in x))}

    return Optimizer(init, update, state_specs)


def make_optimizer(cfg, schedule, moment_dtype=F32):
    """The config's optimizer: Adafactor for `optimizer="adafactor"`,
    else AdamW with `moment_dtype` moments."""
    if cfg.optimizer == "adafactor":
        return adafactor(schedule)
    return adamw(schedule, moment_dtype=moment_dtype)
