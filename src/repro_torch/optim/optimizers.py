"""Optimizers over trees (nested dicts, lists, tuples) of torch tensors.
Port of `repro.optim.optimizers`, its AdamW: the projected-Adam design
optimizer (`optim.dse_opt`) runs it.

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

Adafactor, `make_optimizer` and the training schedules wait for ROADMAP
Queue 1 item 13c (the model stack's training).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch._deferred import deferred

F32 = torch.float32


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the trees of the same structure
    in `rest`; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree):
    """float32 l2 norm over every leaf."""
    return torch.sqrt(sum((g.to(F32) ** 2).sum() for g in _leaves(tree)))


def _clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / gn.clamp_min(1e-9), 1.0)
    return _map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


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
        return {"mu": _map(zeros, params), "nu": _map(zeros, params)}

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

        out = _map(upd, grads, state["mu"], state["nu"], params)
        pick = lambda i: _map(lambda _, o: o[i], params, out)  # noqa: E731
        return pick(0), {"mu": pick(1), "nu": pick(2)}, \
            {"grad_norm": gn, "lr": lr}

    def state_specs(param_specs, param_shapes=None):
        return {"mu": param_specs, "nu": param_specs}

    return Optimizer(init, update, state_specs)


_TRAINING = "Queue 1 item 13c (model stack, training)"
adafactor = deferred("optimizers.adafactor", _TRAINING)
make_optimizer = deferred("optimizers.make_optimizer", _TRAINING)
