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

`specs` is the reference's logical-axis tree of the weights.

Under a mesh (DTensor weights, the model's sharding context active) the
reference's two shard_map paths run through `local_map`: each rank runs
`_moe_local` on its own slices, keeps only the assignments routed to its
experts (`e_offset`, `E_loc = w1.shape[0]`; the slots come from the full
router view, so every rank agrees on them), and the ranks' partial
outputs are summed by one all-reduce; no token moves all-to-all.
  * `_apply_small_t` (decode scale: `B*S <= SMALL_T`, E a multiple of the
    'model' axis and d_ff of the data axes): tokens replicated over the
    whole mesh, experts over 'model' and expert d_ff over the data axes,
    capacity C = T (dropless); y and aux summed over every axis.
  * `_apply_parallel`, expert-parallel when E is a multiple of the
    'model' axis (arctic, 128 over 16: each rank owns E / model experts),
    else tensor-parallel on d_ff (mixtral, 8 over 16: w1/w3 split on
    their last axis, w2 on its middle one); tokens split over the data
    axes when B*S divides them (each shard takes its capacity from its
    own T), else replicated; y summed over 'model'.
The aux loss comes out as the mean over the data shards (the
reference's pmean over every axis). `SMALL_T` is read at call time
(`launch.dryrun` sets it to 0 for the baseline, as the reference's
REPRO_MOE_SMALL_T=0). Under autograd the replicated inputs' gradients
are partial sums over the axes whose ranks computed different parts.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import act_fn, axis_sizes, current_mesh, \
    dense_init, dtype_of, is_dtensor, param, shard_act

# token counts up to this take the 2-D weight-stationary path under a
# mesh (read at call time; 0 turns the path off)
SMALL_T = 4096
_MODEL_AXIS = "model"


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


def _one_hot(idx, E):
    """F.one_hot(idx, E) (int64) as a comparison, with no check of idx's
    values: the same operations on real and fake tensors, and no host
    sync on the card."""
    return (idx[:, None] == torch.arange(E, device=idx.device)).long()


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
    ce = _one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


def _moe_local(x, router_w, w1, w3, w2, cfg, e_offset=0, capacity=None):
    """x: (T, d) -> (y (T, d) in x's dtype, aux). w*: the local experts
    (E_loc, d, f_loc) from global expert `e_offset`; an assignment routed
    outside [e_offset, e_offset + E_loc) adds nothing here. `capacity`
    defaults to ceil(T * k * capacity_factor / E)."""
    T, d = x.shape
    E = cfg.n_experts
    E_loc = w1.shape[0]
    k = cfg.top_k
    act = act_fn(cfg.act)

    gates, idx, aux = _route(x.float(), router_w, k)
    flat_e = idx.reshape(-1)                        # (T*k,) token-major
    flat_g = gates.reshape(-1)

    # rank of each assignment among its expert's, in token order
    onehot = _one_hot(flat_e, E)                    # (T*k, E)
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, flat_e[:, None])[:, 0]
    C = capacity or max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
    le = flat_e - e_offset
    keep = slot < C
    if E_loc != E:
        keep = keep & (le >= 0) & (le < E_loc)
        le = torch.clamp(le, 0, E_loc - 1)
    slot_c = torch.clamp(slot, 0, C - 1)

    # dispatch: each kept assignment writes its own (expert, rank) row;
    # the others write the spare row C, cut off below
    buf = x.new_zeros((E_loc, C + 1, d))
    buf[le, torch.where(keep, slot, C)] = \
        x[:, None].expand(T, k, d).reshape(T * k, d)
    buf = buf[:, :C]

    h = act(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    out_e = torch.bmm(h, w2)                        # (E_loc, C, d)

    # combine: gather the expert outputs back, weighted by the gates in
    # the working dtype, and add a token's k contributions in order
    contrib = out_e[le, slot_c] * (flat_g * keep).to(
        out_e.dtype)[:, None]
    contrib = contrib.view(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, aux


def apply(p, x, cfg):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux loss). Under a mesh
    with a 'model' axis and DTensor weights, the small-T path or the
    expert-/tensor-parallel one (module docstring)."""
    B, S, d = x.shape
    mesh = current_mesh()
    if mesh is None or _MODEL_AXIS not in mesh.mesh_dim_names \
            or not is_dtensor(p.w1):
        y, aux = _moe_local(x.reshape(B * S, d), p.router, p.w1, p.w3,
                            p.w2, cfg)
        return y.reshape(B, S, d), aux
    sizes = axis_sizes(mesh)
    m = sizes[_MODEL_AXIS]
    n_data = math.prod(v for a, v in sizes.items() if a != _MODEL_AXIS)
    E = cfg.n_experts
    ep = E % m == 0 and E >= m
    if B * S <= SMALL_T and ep and cfg.d_ff % n_data == 0:
        return _apply_small_t(p, x, cfg, mesh)
    return _apply_parallel(p, x, cfg, mesh, ep)


def _apply_small_t(p, x, cfg, mesh):
    """The decode-scale path: tokens replicated over the whole mesh, the
    weights in their 2-D shards (experts over 'model', expert d_ff over
    the data axes), dropless (C = T); one all-reduce of (T, d)."""
    T = x.shape[0] * x.shape[1]
    modes = {a: "partial" for a in mesh.mesh_dim_names}
    data = tuple(a for a in mesh.mesh_dim_names if a != _MODEL_AXIS)
    w13 = _placements(mesh, {_MODEL_AXIS: 0, **{a: 2 for a in data}})
    w2 = _placements(mesh, {_MODEL_AXIS: 0, **{a: 1 for a in data}})
    return _run(p, x, cfg, mesh, modes, (w13, w13, w2), expert_split=True,
                capacity=T)


def _apply_parallel(p, x, cfg, mesh, ep):
    """Expert-parallel (`ep`: experts over 'model') or tensor-parallel on
    d_ff; tokens split over the data axes when B*S divides them."""
    B, S, _ = x.shape
    sizes = axis_sizes(mesh)
    data = tuple(a for a in mesh.mesh_dim_names if a != _MODEL_AXIS)
    n_data = math.prod(sizes[a] for a in data)
    split = "split" if (B * S) % n_data == 0 else "same"
    modes = {a: (split if a in data else "partial")
             for a in mesh.mesh_dim_names}
    if ep:
        w13 = w2 = _placements(mesh, {_MODEL_AXIS: 0})
    else:
        w13 = _placements(mesh, {_MODEL_AXIS: 2})
        w2 = _placements(mesh, {_MODEL_AXIS: 1})
    return _run(p, x, cfg, mesh, modes, (w13, w13, w2), expert_split=ep)


def _placements(mesh, shard_dims):
    """Placements sharding tensor dimension shard_dims[axis] over each
    named mesh axis, replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(shard_dims[a]) if a in shard_dims else Replicate()
                 for a in mesh.mesh_dim_names)


def _run(p, x, cfg, mesh, modes, w_pl, *, expert_split, capacity=None):
    """`_moe_local` on every rank through `local_map`. modes[axis]:
    "split" (tokens split over it), "partial" (weights split over it,
    tokens replicated; the outputs summed) or "same" (everything
    replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.mesh import coordinate
    B, S, d = x.shape
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    rep = Replicate()
    on = {"split": Shard(0), "partial": rep, "same": rep}
    grad = {"split": Partial(), "partial": Partial(), "same": rep}
    x_pl = tuple(on[modes[a]] for a in names)
    x_grad = tuple(Shard(0) if modes[a] == "split" else grad[modes[a]]
                   for a in names)
    r_grad = tuple(grad[modes[a]] for a in names)
    w_grad = tuple(tuple(Partial() if modes[a] == "split"
                         else pl[i] if modes[a] == "partial" else rep
                         for i, a in enumerate(names)) for pl in w_pl)
    y_pl = tuple(Shard(0) if modes[a] == "split" else
                 Partial() if modes[a] == "partial" else rep for a in names)
    aux_pl = tuple(rep if modes[a] == "same" else Partial() for a in names)
    n_sum = math.prod(sizes[a] for a in names if modes[a] != "same")
    e_offset = 0
    if expert_split:
        e_offset = coordinate(mesh, [_MODEL_AXIS]) * (
            cfg.n_experts // sizes[_MODEL_AXIS])
    n_split = math.prod(sizes[a] for a in names if modes[a] == "split")
    flat = B % n_split != 0       # split the tokens, not the batch
    if flat:
        x = x.redistribute(mesh, (rep,) * len(names)).reshape(B * S, d)

    def fn(xl, router_w, w1, w3, w2):
        y, aux = _moe_local(xl.reshape(-1, d), router_w, w1, w3, w2, cfg,
                            e_offset, capacity)
        return y.view(xl.shape), aux / n_sum

    y, aux = local_map(
        fn, out_placements=(y_pl, aux_pl),
        in_placements=(x_pl, (rep,) * len(names)) + w_pl,
        in_grad_placements=(x_grad, r_grad) + w_grad,
        device_mesh=mesh, redistribute_inputs=True)(
            x, p.router, p.w1, p.w3, p.w2)
    aux = aux.redistribute(mesh, (rep,) * len(names))
    if flat:
        y = y.redistribute(mesh, (rep,) * len(names)).reshape(B, S, d)
    return shard_act(y, "batch", "seq", "embed"), aux
