"""Transformer blocks: the dense decoder block (attention plus gated MLP),
the MoE decoder block (attention plus the MoE FFN, with arctic's
parallel dense residual MLP), and the audio family's encoder block
(bidirectional, no rotation) and decoder block with cross-attention
(port of `repro.models.transformer`). Residual wiring and norms live
here, attention math in attention.py, MoE math in moe.py.
"""
from __future__ import annotations

import math

from torch import nn

from repro_torch.models import attention, moe
from repro_torch.models.common import act_fn, dense_init, dtype_of, \
    gathered, norm, norm_init, norm_specs, param, shard_act
from repro_torch.runtime.telemetry import span


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """w1, w3 (d, f) and w2 (f, d); f is `d_ff`, else cfg.d_ff."""

    def __init__(self, cfg, gen=None, device="cuda", d_ff=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.w1 = param(dense_init(gen, (d, f), dt, device=device))
        self.w3 = param(dense_init(gen, (d, f), dt, device=device))
        self.w2 = param(dense_init(gen, (f, d), dt, scale=1.0 / math.sqrt(f),
                                   device=device))


def mlp_init(gen, cfg, device="cuda", d_ff=None) -> MLP:
    return MLP(cfg, gen, device=device, d_ff=d_ff)


def mlp_specs(cfg):
    return {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
            "w2": ("mlp", "embed")}


def mlp_apply(p, x, cfg):
    act = act_fn(cfg.act)
    w1, w3, w2 = gathered(p.w1), gathered(p.w3), gathered(p.w2)
    h = shard_act(act(x @ w1) * (x @ w3), "batch", "seq", "mlp")
    return shard_act(h @ w2, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Dense decoder block (llama/qwen/minicpm backbone)
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """n1, attn, n2, mlp: the reference's dense block parameter dict."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        self.n1 = norm_init(cfg, device=device)
        self.attn = attention.init(gen, cfg, device=device)
        self.n2 = norm_init(cfg, device=device)
        self.mlp = mlp_init(gen, cfg, device=device)


def dense_block_init(gen, cfg, device="cuda") -> DenseBlock:
    return DenseBlock(cfg, gen, device=device)


def dense_block_specs(cfg):
    return {
        "n1": norm_specs(cfg),
        "attn": attention.specs(cfg),
        "n2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def dense_block_apply(p, x, positions, cfg):
    a, _, _ = attention.attend_train(p.attn, norm(x, p.n1, cfg), positions,
                                     cfg)
    x = x + a
    return x + mlp_apply(p.mlp, norm(x, p.n2, cfg), cfg)


def dense_block_prefill(p, x, positions, cfg):
    with span("attn", device=x.device):
        a, k, v = attention.attend_train(p.attn, norm(x, p.n1, cfg),
                                         positions, cfg)
    x = x + a
    return x + mlp_apply(p.mlp, norm(x, p.n2, cfg), cfg), (k, v)


def dense_block_decode(p, x, ck, cv, pos, cfg, ring=False, scales=None):
    with span("attn", device=x.device):
        out = attention.decode(p.attn, norm(x, p.n1, cfg), ck, cv, pos, cfg,
                               ring=ring, scales=scales)
    a, ck, cv = out[:3]
    x = x + a
    y = x + mlp_apply(p.mlp, norm(x, p.n2, cfg), cfg)
    if scales is not None:
        return y, ck, cv, out[3]
    return y, ck, cv


# ---------------------------------------------------------------------------
# MoE decoder block (mixtral / arctic). arctic adds a parallel dense
# residual MLP beside the MoE FFN.
# ---------------------------------------------------------------------------

class MoEBlock(nn.Module):
    """n1, attn, n2, moe, and with `cfg.moe_dense_ff` dense_mlp."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        self.n1 = norm_init(cfg, device=device)
        self.attn = attention.init(gen, cfg, device=device)
        self.n2 = norm_init(cfg, device=device)
        self.moe = moe.init(gen, cfg, device=device)
        if cfg.moe_dense_ff:
            self.dense_mlp = mlp_init(gen, cfg, device=device,
                                      d_ff=cfg.moe_dense_ff)


def moe_block_init(gen, cfg, device="cuda") -> MoEBlock:
    return MoEBlock(cfg, gen, device=device)


def moe_block_specs(cfg):
    p = {
        "n1": norm_specs(cfg),
        "attn": attention.specs(cfg),
        "n2": norm_specs(cfg),
        "moe": moe.specs(cfg),
    }
    if cfg.moe_dense_ff:
        p["dense_mlp"] = mlp_specs(cfg)
    return p


def _moe_ffn(p, h, cfg):
    y, aux = moe.apply(p.moe, h, cfg)
    if cfg.moe_dense_ff:
        y = y + mlp_apply(p.dense_mlp, h, cfg)
    return y, aux


def moe_block_apply(p, x, positions, cfg):
    a, _, _ = attention.attend_train(p.attn, norm(x, p.n1, cfg), positions,
                                     cfg)
    x = x + a
    y, aux = _moe_ffn(p, norm(x, p.n2, cfg), cfg)
    return x + y, aux


def moe_block_prefill(p, x, positions, cfg):
    with span("attn", device=x.device):
        a, k, v = attention.attend_train(p.attn, norm(x, p.n1, cfg),
                                         positions, cfg)
    x = x + a
    y, aux = _moe_ffn(p, norm(x, p.n2, cfg), cfg)
    return x + y, (k, v), aux


def moe_block_decode(p, x, ck, cv, pos, cfg, ring=False, scales=None):
    with span("attn", device=x.device):
        out = attention.decode(p.attn, norm(x, p.n1, cfg), ck, cv, pos, cfg,
                               ring=ring, scales=scales)
    a, ck, cv = out[:3]
    x = x + a
    y, _ = _moe_ffn(p, norm(x, p.n2, cfg), cfg)
    if scales is not None:
        return x + y, ck, cv, out[3]
    return x + y, ck, cv


# ---------------------------------------------------------------------------
# Encoder block (whisper encoder: bidirectional, layernorm + gelu); its
# parameters are the dense block's
# ---------------------------------------------------------------------------

def enc_block_init(gen, cfg, device="cuda") -> DenseBlock:
    return DenseBlock(cfg, gen, device=device)


enc_block_specs = dense_block_specs


def enc_block_apply(p, x, cfg):
    with span("attn", device=x.device):
        a, _, _ = attention.attend_train(p.attn, norm(x, p.n1, cfg), None,
                                         cfg, use_rope=False, causal=False)
    x = x + a
    return x + mlp_apply(p.mlp, norm(x, p.n2, cfg), cfg)


# ---------------------------------------------------------------------------
# Decoder block with cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

class XDecBlock(nn.Module):
    """n1, attn, n2, xattn, n3, mlp: the reference's cross-attention
    decoder block parameter dict."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        self.n1 = norm_init(cfg, device=device)
        self.attn = attention.init(gen, cfg, device=device)
        self.n2 = norm_init(cfg, device=device)
        self.xattn = attention.init(gen, cfg, device=device)
        self.n3 = norm_init(cfg, device=device)
        self.mlp = mlp_init(gen, cfg, device=device)


def xdec_block_init(gen, cfg, device="cuda") -> XDecBlock:
    return XDecBlock(cfg, gen, device=device)


def xdec_block_specs(cfg):
    return {
        "n1": norm_specs(cfg),
        "attn": attention.specs(cfg),
        "n2": norm_specs(cfg),
        "xattn": attention.specs(cfg),
        "n3": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def xdec_block_apply(p, x, enc_out, positions, cfg):
    """Causal self-attention (no rotation), cross-attention against
    `enc_out`, MLP. Returns (y, (k, v), (xk, xv))."""
    with span("attn", device=x.device):
        a, k, v = attention.attend_train(p.attn, norm(x, p.n1, cfg),
                                         positions, cfg, use_rope=False)
    x = x + a
    xk, xv = attention.cross_kv(p.xattn, enc_out)
    x = x + attention.cross_attend_train(p.xattn, norm(x, p.n2, cfg),
                                         (xk, xv), cfg)
    return (x + mlp_apply(p.mlp, norm(x, p.n3, cfg), cfg), (k, v),
            (xk, xv))


def xdec_block_decode(p, x, ck, cv, xk, xv, pos, cfg):
    """One token: self-attention against the cache (written in place),
    cross-attention against the static encoder K/V, MLP."""
    with span("attn", device=x.device):
        a, ck, cv = attention.decode(p.attn, norm(x, p.n1, cfg), ck, cv,
                                     pos, cfg, use_rope=False)
    x = x + a
    x = x + attention.cross_decode(p.xattn, norm(x, p.n2, cfg), xk, xv)
    return x + mlp_apply(p.mlp, norm(x, p.n3, cfg), cfg), ck, cv
