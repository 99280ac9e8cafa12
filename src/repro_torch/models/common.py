"""Shared model building blocks: norms, activations, RoPE, sinusoidal
positions and init (port of `repro.models.common`).

Weights live in `nn.Module`s whose parameter names follow the keys of the
reference's parameter dicts ("scale", "wq", "w1", ...), so a reference
tree maps onto a port module name for name (`repro_torch.interop`).
Parameters are made with `requires_grad=False`: serving runs no autograd,
and training differentiates a tree of tensors passed to `Model.loss`
(the trainer's float32 master, cast). Random draws take an explicit
`torch.Generator`.

On one card there is no mesh: `shard_act` is the identity, and the
reference's XLA mesh helpers (`sharding_ctx`, `logical_to_pspec`,
`current_mesh`) have no counterpart.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


def shard_act(x, *logical_axes):
    """Activation sharding annotation of the reference; the identity on
    one card."""
    return x


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
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


def norm_init(cfg, device="cuda") -> Norm:
    return Norm(cfg, device=device)


def act_fn(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def dense_init(gen, shape, dtype, scale=None, device="cuda"):
    """Truncated-normal fan-in init: N(0, 1) cut to [-3, 3] in float32,
    times 1/sqrt(fan_in) (or `scale`), cast to `dtype`. On the meta device
    only the shape is made."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
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


def embed(tokens, w):
    """w[tokens]: (..., d). Under autograd the weight's gradient is summed
    in a fixed order (`_Embed`), so a train step is bit-reproducible on
    the card."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _Embed.apply(tokens, w)
    return F.embedding(tokens, w)


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materializes (B, S, V) logits in one piece
# ---------------------------------------------------------------------------

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
    w32 = w_unembed.float()
    V = w32.shape[-1]

    def one(hc, lc, w):
        logits = hc.float() @ w                           # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp(lc, 0, V - 1).long()
        tgt = logits.gather(-1, safe[..., None])[..., 0]
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
