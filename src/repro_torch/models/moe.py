"""Mixture-of-Experts FFN: top-k routing with capacity, scatter dispatch
(port of `repro.models.moe`, its `mesh=None` path).

On one card every expert is local (the reference's `e_offset = 0` and
`E_loc = E`): `_moe_local` routes in float32, ranks each assignment
within its expert by a cumulative count in token-major order (token t's
k assignments, then token t + 1's), drops every assignment whose rank
reaches the capacity `C = max(1, ceil(T * k * capacity_factor / E))`,
gathers the kept tokens into an (E, C, d) buffer, runs the three expert
products as batched matrix products in the working dtype, and adds each
token's k weighted contributions in the working dtype, in assignment
order. No atomics: a kept assignment owns its (expert, rank) row of the
buffer, so the dispatch is a plain index write (dropped ones go to a
spare row that is cut off), and the combine is a sum over the k axis.
The k copies of a token are an expand, not a gather, so under autograd
their gradients meet in a sum over k, in order, with no scattered add.
T counts every row the caller passes, so capacity drops depend on the
batch, as in the reference.

`specs` is the reference's logical-axis tree of the weights. The
expert-parallel and tensor-parallel shard_map paths of the reference
(`moe.py:123,153`) wait for ROADMAP Queue 1 item 13e; `Model(cfg,
mesh=...)` refuses the family until then.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import act_fn, dense_init, dtype_of, param


class MoE(nn.Module):
    """router (d, E) float32, w1/w3 (E, d, f) and w2 (E, f, d) in the
    working dtype."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = dtype_of(cfg)
        self.router = param(dense_init(gen, (d, E), torch.float32,
                                       device=device))
        self.w1 = param(dense_init(gen, (E, d, f), dt, device=device))
        self.w3 = param(dense_init(gen, (E, d, f), dt, device=device))
        self.w2 = param(dense_init(gen, (E, f, d), dt,
                                   scale=1.0 / math.sqrt(f), device=device))


def init(gen, cfg, device="cuda") -> MoE:
    return MoE(cfg, gen, device=device)


def specs(cfg):
    return {
        "router": ("embed", None),
        "w1": ("experts", "embed", "expert_mlp"),
        "w3": ("experts", "embed", "expert_mlp"),
        "w2": ("experts", "expert_mlp", "embed"),
    }


def _route(x32, router_w, k):
    """x32: (T, d) float32. Returns gates (T, k), expert ids (T, k) and
    the load-balancing aux loss. The top k are taken by a stable
    descending sort, so equal probabilities rank the lower expert first,
    as `jax.lax.top_k` does."""
    logits = x32 @ router_w                                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    E = router_w.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


def _moe_local(x, router_w, w1, w3, w2, cfg):
    """x: (T, d) -> (y (T, d) in x's dtype, aux)."""
    T, d = x.shape
    E = cfg.n_experts
    k = cfg.top_k
    act = act_fn(cfg.act)

    gates, idx, aux = _route(x.float(), router_w, k)
    flat_e = idx.reshape(-1)                        # (T*k,) token-major
    flat_g = gates.reshape(-1)

    # rank of each assignment among its expert's, in token order
    onehot = F.one_hot(flat_e, E)                   # (T*k, E)
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, flat_e[:, None])[:, 0]
    C = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
    keep = slot < C
    slot_c = torch.clamp(slot, 0, C - 1)

    # dispatch: each kept assignment writes its own (expert, rank) row;
    # dropped ones write the spare row C, cut off below
    buf = x.new_zeros((E, C + 1, d))
    buf[flat_e, torch.where(keep, slot, C)] = \
        x[:, None].expand(T, k, d).reshape(T * k, d)
    buf = buf[:, :C]

    h = act(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    out_e = torch.bmm(h, w2)                        # (E, C, d)

    # combine: gather the expert outputs back, weighted by the gates in
    # the working dtype, and add a token's k contributions in order
    contrib = out_e[flat_e, slot_c] * (flat_g * keep).to(
        out_e.dtype)[:, None]
    contrib = contrib.view(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, aux


def apply(p, x, cfg):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux loss)."""
    B, S, d = x.shape
    y, aux = _moe_local(x.reshape(B * S, d), p.router, p.w1, p.w3, p.w2,
                        cfg)
    return y.reshape(B, S, d), aux
