"""The benchmark's own count of operations and bytes, and the card's peaks.

Frozen here so that a change to the program cannot change the yardstick:
nothing is imported from the program. Every count is worked out from a
configuration file's widths (the keys of `perfbench/configs/*.json`) and
from the shapes a run records. What differs between model types, the
weights a token multiplies through and the number of attention layers,
is in the counts module named by the file's model type
(`perfbench/counts/<model_type>.py`, `common.counts`).

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import numpy as np

from perfbench.harness.common import counts

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(Sq: int, Skv: int, *, q_offset: int = 0,
                  causal: bool = True, window: int = 0,
                  kv_len: int | None = None) -> int:
    """(query, key) pairs one head of attention needs: query i sits at
    position q_offset + i and sees key j < kv_len, with j <= q_offset + i
    when causal, and q_offset + i - j < window when a window is set."""
    kv_len = Skv if kv_len is None else kv_len
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(Sq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def attention_flops(pairs: int, heads: int, head_dim: int) -> float:
    """Q K^T and P V: two products of 2 * head_dim operations a pair."""
    return 4.0 * head_dim * pairs * heads


def flash_bound_s(B, Sq, Skv, H, K, hd, q_offset=0, kv_len=None,
                  causal=True, window=0, elem_bytes=2) -> float:
    """The least time one flash-attention forward launch could take: the
    larger of its operations at the bf16 peak and its bytes (Q, K, V read
    once, O written once) at the HBM rate."""
    pairs = visible_pairs(Sq, Skv, q_offset=q_offset, causal=causal,
                          window=window, kv_len=kv_len)
    ops = B * attention_flops(pairs, H, hd)
    nbytes = elem_bytes * (2 * B * Sq * H * hd + 2 * B * Skv * K * hd)
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Model operations per token, from a configuration file's widths
# ---------------------------------------------------------------------------

def head_dim(c) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def _other(k, name, c, x) -> float:
    """A model type's operations that are not weight products (a scan's,
    say): its counts module's `name(c, x)`, or none."""
    f = getattr(k, name, None)
    return f(c, x) if f is not None else 0.0


def prefill_flops(c, B: int, S: int) -> float:
    """One prefill of B prompts of S tokens: every layer for every token
    (the counts module's weights a token multiplies, 2 operations each),
    causal attention in its attention layers (within the window, if one is
    set), the type's other operations, and the logits of the last
    position."""
    k = counts(c)
    hd = head_dim(c)
    pairs = visible_pairs(S, S, window=c.get("sliding_window") or 0)
    per_seq = (S * 2.0 * k.layer_matmul_params(c)
               + k.attention_layers(c) * attention_flops(
                   pairs, c["num_attention_heads"], hd)
               + 2.0 * c["hidden_size"] * c["vocab_size"]) \
        + _other(k, "other_prefill_flops", c, S)
    return B * per_seq


def decode_flops(c, context: float) -> float:
    """One decoded token that attends to `context` cached positions."""
    k = counts(c)
    W = c.get("sliding_window") or 0
    ctx = min(context, W) if W else context
    return (2.0 * k.layer_matmul_params(c)
            + 2.0 * c["hidden_size"] * c["vocab_size"]
            + k.attention_layers(c) * attention_flops(
                ctx, c["num_attention_heads"], head_dim(c))) \
        + _other(k, "other_decode_flops", c, context)
