"""Shared model building blocks: norms, activations, RoPE, sinusoidal
positions and init (port of `repro.models.common`).

Weights live in `nn.Module`s whose parameter names follow the keys of the
reference's parameter dicts ("scale", "wq", "w1", ...), so a reference
tree maps onto a port module name for name (`repro_torch.interop`).
Parameters are made with `requires_grad=False`: serving runs no autograd,
and training differentiates a tree of tensors passed to `Model.loss`
(the trainer's float32 master, cast). Random draws take an explicit
`torch.Generator`.

Sharding context (the reference's): model code names the LOGICAL axes of
its activations (`shard_act`); inside `sharding_ctx(mesh, rules)` (a torch
`DeviceMesh` and a `launch.sharding.make_rules` table) a DTensor
activation is redistributed to the placements the rules give, the
counterpart of `with_sharding_constraint`; outside one, or on a plain
tensor, `shard_act` is the identity. `logical_to_pspec` maps logical axes
to the per-dimension mesh-axis tuple the reference's `PartitionSpec`
holds, and `to_placements` turns that into DTensor placements.
"""
from __future__ import annotations

import contextlib
import functools
import math
import sys
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}

# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

# process-wide, not per thread: autograd runs a CUDA backward, and the
# recompute of a checkpointed block in it, on a thread of its own, which
# must see the context of the step that started it
_CTX = types.SimpleNamespace(val=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules):
    """rules: dict logical_axis -> mesh axis name (or tuple, or None)."""
    prev = getattr(_CTX, "val", None)
    _CTX.val = (mesh, rules)
    try:
        yield
    finally:
        _CTX.val = prev


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a torch `DeviceMesh` (its mesh_dim_names), or
    of anything with the reference's `.shape` dict (`launch.mesh.
    AbstractMesh`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_to_pspec(logical_axes, rules, shape=None, mesh=None) -> tuple:
    """Map a tuple of logical axis names to the reference's PartitionSpec
    entries via `rules`: per dimension None, a mesh axis name, or a tuple
    of them; trailing Nones dropped.

    Divisibility fallback: if `shape`/`mesh` given and the dim size is not
    divisible by the product of assigned mesh-axis sizes, replicate that dim.
    A mesh axis may be used at most once in the spec (first logical axis wins).
    """
    sizes = axis_sizes(mesh) if mesh is not None else None
    used = set()
    out = []
    for i, name in enumerate(logical_axes):
        assign = rules.get(name)
        if assign is None:
            out.append(None)
            continue
        axes = assign if isinstance(assign, tuple) else (assign,)
        axes = tuple(a for a in axes if a is not None and a not in used)
        if not axes:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            if shape[i] % math.prod(sizes[a] for a in axes) != 0:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements, one per mesh dimension, of a `logical_to_pspec`
    spec: Shard(i) on every mesh axis that dimension i names, Replicate
    elsewhere. A dimension over several axes is split major to minor in
    the mesh's order (the only order DTensor's Shard expresses)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {i} is sharded over {axes}, not "
                             f"in the mesh's axis order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def current_mesh():
    """The mesh of the active sharding context (None outside one)."""
    ctx = getattr(_CTX, "val", None)
    return ctx[0] if ctx is not None else None


def shard_act(x, *logical_axes):
    """Annotate activation x with logical axes: inside a sharding context
    a DTensor is redistributed to the placements the rules give (Partial
    sums reduced), and its gradient to the same; the identity without a
    context or on a plain tensor."""
    return shard_act_as(x, x.shape, *logical_axes)


def shard_act_as(x, shape, *logical_axes):
    """`shard_act` with the placements the rules give a tensor of `shape`
    (x's leading dimensions, before a view splits its last one)."""
    ctx = getattr(_CTX, "val", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    want = to_placements(logical_to_pspec(logical_axes, rules, shape=shape,
                                          mesh=mesh), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return _keep_grad_layout(x)


def _keep_grad_layout(x):
    """x, whose gradient is redistributed to x's placements: the
    constraint binds the cotangent too, as jax's with_sharding_constraint
    does."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GradLayout.apply(x)
    return x


_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether x is a DTensor. There is none until torch.distributed.tensor
    has been imported, so a run without a mesh never imports it; the class
    is looked up once (an import statement here costs ~11 us a call, and
    the model asks this ~19 times a layer a step)."""
    global _DTENSOR
    if _DTENSOR is None:
        _DTENSOR = getattr(sys.modules.get("torch.distributed.tensor"),
                           "DTensor", None)
        if _DTENSOR is None:
            return False
    return isinstance(x, _DTENSOR)


def softmax_last(s):
    """Softmax over the last axis. A DTensor whose last axis is sharded
    (the decode rules' kv_seq) takes the max and the sum as partial
    reductions, two small all-reduces, where torch.softmax would gather
    the scores whole."""
    if not is_dtensor(s) or not any(pl.is_shard(s.dim() - 1)
                                    for pl in s.placements):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def gathered(w):
    """A weight as its consumer uses it: a DTensor gathered over every
    mesh axis but 'model' (the FSDP shard of its embed dimension, as the
    reference's rules place it), its tensor-parallel shard over 'model'
    kept. Gathering before each use makes every product's layout the
    reference's (batch over the data axes, heads or mlp over 'model'),
    not one DTensor's cost model picks; under autograd the gradient comes
    back reduce-scattered to the weight's shard. A plain tensor is
    returned as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    want = tuple(pl if name == "model" else Replicate()
                 for name, pl in zip(mesh.mesh_dim_names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(mesh, want)


class Gathered:
    """Attribute access to a module's (or a `_View`'s) weights, each
    `gathered` where it is read: the layer code of the families that run
    under a mesh through their layouts alone reads its weights so."""

    def __init__(self, p):
        self._p = p

    def __getattr__(self, name):
        return gathered(getattr(self._p, name))


class _GradLayout(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the input's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def reshaped(w, *shape):
    """w.reshape(*shape); for a DTensor that needs a gradient, the
    gradient reaches the reshape laid out as the forward's result was,
    so that it splits back into w's shape (DTensor may give a product's
    gradient a layout that does not)."""
    out = w.reshape(*shape)
    return _keep_grad_layout(out) if is_dtensor(out) else out


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of the serving slice (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


def rms_norm(x, scale, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """Parameters of one norm (`norm_init`): "scale", plus "bias" for
    layernorm."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        d, dt = cfg.d_model, dtype_of(cfg)
        self.scale = param(torch.ones((d,), dtype=dt, device=device))
        if cfg.norm == "layernorm":
            self.bias = param(torch.zeros((d,), dtype=dt, device=device))


def norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, gathered(p.scale), gathered(p.bias),
                          cfg.norm_eps)
    return rms_norm(x, gathered(p.scale), cfg.norm_eps)


def norm_init(cfg, device="cuda") -> Norm:
    return Norm(cfg, device=device)


def norm_specs(cfg):
    p = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        p["bias"] = ("embed",)
    return p


def act_fn(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def dense_init(gen, shape, dtype, scale=None, device="cuda"):
    """Truncated-normal fan-in init: N(0, 1) cut to [-3, 3] in float32,
    times 1/sqrt(fan_in) (or `scale`), cast to `dtype`. On the meta device,
    and under a FakeTensorMode (a dry run), only the shape is made."""
    from torch._subclasses.fake_tensor import is_fake
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta" and not is_fake(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
        t.mul_(std)
    return t.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding, computed from integer positions
# ---------------------------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., S, H, hd), positions: broadcastable to (..., S). Rotates
    the two halves of the head dimension (not interleaved pairs), in
    float32, and casts back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal absolute positions (the audio family's encoder and decoder)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _sinusoids_np(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=-1).astype(np.float32)


def sinusoidal_positions(n, d, device="cpu"):
    """(n, d) float32 table of positions 0..n-1: computed in numpy float64
    and cast to float32, as the reference's (prefill uses this one)."""
    return torch.as_tensor(_sinusoids_np(n, d), device=device)


def sinusoid_at(pos, d):
    """Sinusoidal embedding of integer positions, in float32 on pos's
    device (decode uses this one). pos: (B,) -> (B, 1, d). Divides by
    tensors (a CUDA division by a Python number multiplies by its
    reciprocal)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    expo = i * 2 / i.new_tensor(float(d))
    ang = pos[:, None].float() / torch.pow(i.new_tensor(10000.0), expo)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None, :]


# ---------------------------------------------------------------------------
# Token embedding with an ordered backward
# ---------------------------------------------------------------------------

class _Embed(torch.autograd.Function):
    """F.embedding whose weight gradient sums each token's rows in a fixed
    order: a float32 `index_put_(accumulate=True)`, which sorts the
    indices and adds duplicates in sequence on the card (no atomics),
    cast to the weight's dtype at the end."""

    @staticmethod
    def forward(ctx, tokens, w):
        ctx.save_for_backward(tokens)
        ctx.w_shape, ctx.w_dtype = w.shape, w.dtype
        return F.embedding(tokens, w)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        gw = torch.zeros(ctx.w_shape, dtype=torch.float32, device=g.device)
        gw.index_put_((tokens.reshape(-1).long(),),
                      g.reshape(-1, ctx.w_shape[1]).float(), accumulate=True)
        return None, gw.to(ctx.w_dtype)


def _mesh_embed(tokens, w):
    """`embed` of a DTensor table under autograd. DTensor's lookup in a
    vocab-sharded table leaves a masked partial sum that no gradient can
    be redistributed to, so the table is gathered whole first, as FSDP
    gathers a weight; then `local_map` runs `_Embed` on each rank's
    tokens, so the table's gradient is summed in the same fixed float32
    order as without a mesh. That gradient is a partial sum over each
    mesh axis the tokens are split on, which the gather's backward
    reduce-scatters to the table's shards."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    rep = (Replicate(),) * mesh.ndim
    tp = tuple(tokens.placements) if is_dtensor(tokens) else rep
    grad_pl = tuple(Partial() if pl.is_shard() else Replicate() for pl in tp)
    return local_map(_Embed.apply, out_placements=(tp,),
                     in_placements=(tp, rep), in_grad_placements=(tp, grad_pl),
                     device_mesh=mesh)(tokens, w.redistribute(mesh, rep))


def embed(tokens, w):
    """w[tokens]: (..., d). Under autograd the weight's gradient is summed
    in a fixed order (`_Embed`), so a train step is bit-reproducible on
    the card. A DTensor table is looked up by DTensor (a vocab-sharded
    one gives a masked partial sum, which `shard_act` reduces); under
    autograd it is gathered whole first and each rank looks up its own
    tokens through `_Embed` (`_mesh_embed`)."""
    if is_dtensor(w) and torch.is_grad_enabled() and w.requires_grad:
        return _mesh_embed(tokens, w)
    if is_dtensor(w):
        return F.embedding(tokens, gathered(w))
    if torch.is_grad_enabled() and w.requires_grad:
        return _Embed.apply(tokens, w)
    return F.embedding(tokens, w)


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materializes (B, S, V) logits in one piece
# ---------------------------------------------------------------------------

def _logsumexp(x):
    """logsumexp over the last axis. For a DTensor sharded there (the
    vocab), the max and the sum are partial reductions, two small
    all-reduces, where torch.logsumexp would gather the logits whole; the
    max is a constant of the formula, so no gradient goes through it, and
    the exponentials' gradient keeps their layout (the sum's gradient is
    a broadcast, which DTensor would otherwise meet by gathering them)."""
    if not is_dtensor(x) or not any(pl.is_shard(x.dim() - 1)
                                    for pl in x.placements):
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    e = _keep_grad_layout(torch.exp(x - m))
    total = shard_act(e.sum(dim=-1, keepdim=True), "batch", "seq", None)
    return (m + torch.log(total))[..., 0]


def _target_logit(logits, idx):
    """logits[..., idx]: a gather, or for a DTensor a sum over the vocab of
    the logits where the vocab index is idx (exact: the other terms are
    zeros), whose gradient keeps the logits' layout; a gather's gradient
    would scatter into zeros of the whole (B, chunk, V) block."""
    if not is_dtensor(logits):
        return logits.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = logits.dim() - 1
    ids = distribute_tensor(   # the vocab ids laid out as the logits' vocab
        torch.arange(logits.shape[-1], device=logits.device),
        logits.device_mesh, [Shard(0) if pl.is_shard(last) else Replicate()
                             for pl in logits.placements],
        src_data_rank=None)
    hit = ids == idx[..., None]
    picked = _keep_grad_layout(torch.where(hit, logits, 0.0))
    return shard_act(picked.sum(dim=-1), "batch", "seq")


def chunked_softmax_xent(h, w_unembed, labels, chunk=512, ignore_index=-100):
    """h: (B, S, d) final hidden; w_unembed: (d, V); labels: (B, S) int.

    The mean cross-entropy over the positions whose label is not
    `ignore_index`, float32. Runs over chunks of `chunk` positions plus
    the remainder chunk, each under `torch.utils.checkpoint`, so the
    backward recomputes a chunk's (B, chunk, V) float32 logits and only
    one such block lives at a time. Logits are float32 sums of the working
    dtype's products (the unembedding is cast to float32 once), as the
    reference's preferred_element_type; per-chunk sums are added in chunk
    order."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    w32 = gathered(w_unembed).float()
    V = w32.shape[-1]

    def one(hc, lc, w):
        logits = shard_act(hc.float() @ w, "batch", "seq", "vocab")
        lse = _logsumexp(logits)
        safe = torch.clamp(lc, 0, V - 1).long()
        tgt = _target_logit(logits, safe)
        mask = (lc != ignore_index).float()
        return ((lse - tgt) * mask).sum(), mask.sum()

    tot = cnt = h.new_zeros((), dtype=torch.float32)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if S - n * chunk:
        bounds.append((n * chunk, S))
    for a, b in bounds:
        s, c = checkpoint(one, h[:, a:b], labels[:, a:b], w32,
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
