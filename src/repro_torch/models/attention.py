"""GQA attention: flash prefill path and KV-cache decode path, with the
sliding-window ring cache and the int8 cache (port of
`repro.models.attention`).

Prefill attention (`attend_train` and `cross_attend_train` ->
`flash_attention`) calls the flash-attention kernel: a CUDA tensor launches
`csrc/flash_attention.cu` through `kernels.flash_attention.ops` (or
raises), a CPU tensor runs the blocked pure-torch flash attention of the
reference (`kernels.flash_attention.kernel.flash_attention_plain`); a
sliding window goes into the kernel's mask. Decode attends one new token
against the cache in plain torch, as the reference does outside any
Pallas kernel; it writes the new K/V row (and, for an int8 cache, its
scales) into the cache in place. Under a sliding window the cache is a
ring of `window` rows indexed by pos % window (`seed_ring_cache` lays out
a prefill's rows so); an int8 cache holds per-token, per-head symmetric
int8 values with bf16 scales (`quantize_kv`), folded into the scores and
the weights as the reference does.

The audio family (whisper) attends without rotation: its encoder
bidirectionally (`attend_train(..., use_rope=False, causal=False)`), its
decoder causally, and its cross-attention (`cross_attend_train`) against
the encoder's K/V (`cross_kv`) with `causal=False`, so both launch the
flash kernel in non-causal mode on CUDA tensors. Cross-attention during
decode (`cross_decode`) is plain torch, as in the reference. As there,
the cross-attention projections take no bias.

Not ported: the sequence-parallel flash (`_seqpar_flash`,
`_want_seqpar`), XLA mesh code with no counterpart on one card.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import dense_init, dtype_of, param, rope

NEG_INF = -1e30


class Attention(nn.Module):
    """Parameters of one attention layer: wq (d, H, hd), wk/wv (d, K, hd),
    wo (H, hd, d), and with `cfg.qkv_bias` bq (H, hd), bk/bv (K, hd)."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
        dt = dtype_of(cfg)
        self.wq = param(dense_init(gen, (d, H, hd), dt, device=device))
        self.wk = param(dense_init(gen, (d, K, hd), dt, device=device))
        self.wv = param(dense_init(gen, (d, K, hd), dt, device=device))
        self.wo = param(dense_init(gen, (H, hd, d), dt,
                                   scale=1.0 / math.sqrt(H * hd),
                                   device=device))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((H, hd), dtype=dt, device=device))
            self.bk = param(torch.zeros((K, hd), dtype=dt, device=device))
            self.bv = param(torch.zeros((K, hd), dtype=dt, device=device))


def init(gen, cfg, device="cuda") -> Attention:
    return Attention(cfg, gen, device=device)


def _heads_in(x, w):
    """einsum("bsd,dhk->bshk", x, w), contiguous."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _heads_out(o, w):
    """einsum("bshk,hkd->bsd", o, w)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])


def _project(p, x):
    q, k, v = _heads_in(x, p.wq), _heads_in(x, p.wk), _heads_in(x, p.wv)
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _qkv(p, x, cfg, positions, use_rope=True):
    q, k, v = _project(p, x)
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, chunk_q=512, chunk_kv=1024):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H = K * G. Returns (B, Sq,
    H, hd). Float32 online softmax over KV chunks, GQA via head groups."""
    return fa_ops.flash_attention(q, k, v, q_offset, bq=chunk_q,
                                  bkv=chunk_kv, causal=causal, window=window,
                                  kv_len=kv_len)


def attend_train(p, x, positions, cfg, *, use_rope=True, causal=True):
    """Full training/prefill attention, causal unless `causal` is False;
    no rotation with `use_rope=False` or `positions=None`. Returns (out
    (B, S, d), k, v)."""
    q, k, v = _qkv(p, x, cfg, positions, use_rope)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return _heads_out(o, p.wo), k, v


def cross_kv(p, enc_out):
    """The encoder output's K and V for cross-attention: (B, F, K, hd)
    each, no bias (as the reference)."""
    return _heads_in(enc_out, p.wk), _heads_in(enc_out, p.wv)


def cross_attend_train(p, x, enc_kv, cfg):
    """Decoder cross-attention against precomputed encoder K/V, through
    the flash kernel in non-causal mode. Returns (B, S, d)."""
    k, v = enc_kv
    o = flash_attention(_heads_in(x, p.wq), k, v, causal=False)
    return _heads_out(o, p.wo)


def cross_decode(p, x, cross_k, cross_v):
    """Cross-attention of one token (B, 1, d) against the static encoder
    cache (B, F, K, hd), in plain torch: float32 scores from the working
    dtype's operands, softmax, weights rounded to V's dtype."""
    B = x.shape[0]
    q = _heads_in(x, p.wq)
    H, hd = q.shape[2], q.shape[3]
    K = cross_k.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cross_k.float()) / math.sqrt(hd)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(cross_v.dtype), cross_v)
    return _heads_out(o.reshape(B, 1, H, hd), p.wo)


def quantize_kv(k, axis=-1):
    """Symmetric int8 per-token-per-head quantization. k: (..., hd) ->
    (int8 like k, scale (...,) bf16). Rounds half to even, as jnp.round;
    divides by tensors (a CUDA division by a Python number multiplies by
    its reciprocal, which can move a scale by an ulp)."""
    kf = k.float()
    s = kf.abs().amax(dim=axis) / kf.new_tensor(127.0)
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(kf / s.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def seed_ring_cache(k, v, window):
    """Convert full prefill K/V (..., S, K, hd) into a ring cache of
    `window` rows (..., W, K, hd) laid out so that slot = pos % W, ready
    for decode at pos = S: the last W positions when S > W."""
    S = k.shape[-3]
    W = window
    ck = k.new_zeros(k.shape[:-3] + (W,) + k.shape[-2:])
    cv = v.new_zeros(v.shape[:-3] + (W,) + v.shape[-2:])
    if S <= W:
        ck[..., :S, :, :] = k
        cv[..., :S, :, :] = v
        return ck, cv
    idx = torch.arange(S - W, S, device=k.device) % W
    ck[..., idx, :, :] = k[..., S - W:, :, :]
    cv[..., idx, :, :] = v[..., S - W:, :, :]
    return ck, cv


def decode(p, x, cache_k, cache_v, pos, cfg, *, use_rope=True, ring=False,
           scales=None):
    """x: (B, 1, d); cache_k/v: (B, W, K, hd); pos: (B,) int32 current
    index. Writes the new K/V rows at slot pos % W (`ring`) or
    min(pos, W - 1) into the caches in place and returns (out (B, 1, d),
    cache_k, cache_v[, (ks, vs)]). `scales`: (ks, vs), each (B, W, K)
    bf16, for int8 caches; the new rows are quantized, and the scales
    multiply the float32 scores and the softmax weights. No rotation with
    `use_rope=False` (the audio decoder)."""
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg, pos[:, None], use_rope)
    pos = pos.long()
    slot = pos % W if ring else torch.clamp_max(pos, W - 1)
    bidx = torch.arange(B, device=x.device)
    if scales is not None:
        ks, vs = scales
        kq, ksc = quantize_kv(k[:, 0])
        vq, vsc = quantize_kv(v[:, 0])
        cache_k[bidx, slot] = kq
        cache_v[bidx, slot] = vq
        ks[bidx, slot] = ksc
        vs[bidx, slot] = vsc
    else:
        cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)

    H, hd = q.shape[2], q.shape[3]
    K = cache_k.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    # float32 scores from the working dtype's operands
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cache_k.to(q.dtype).float()) / math.sqrt(hd)
    if scales is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    slots = torch.arange(W, device=x.device)[None]
    valid = slots <= slot[:, None]
    if ring:
        valid = valid | (pos[:, None] >= W)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if scales is not None:
        w = w * vs.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskh->bkgh", w.to(q.dtype),
                     cache_v.to(q.dtype))
    o = _heads_out(o.reshape(B, 1, H, hd), p.wo)
    if scales is not None:
        return o, cache_k, cache_v, (ks, vs)
    return o, cache_k, cache_v
