"""Operation counts of the mixtral decoder (`harness/flops.py` reads
them): every layer is attention and a sparse MoE FFN."""
from __future__ import annotations

from perfbench.harness.flops import head_dim


def _attn_params(c) -> int:
    d, H, K = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    hd = head_dim(c)
    return d * H * hd * 2 + d * K * hd * 2


def layer_matmul_params(c) -> float:
    """Weights one token multiplies through in all the layers (the experts
    at experts-per-token of their count): 2 operations each."""
    d, f, L = c["hidden_size"], c["intermediate_size"], \
        c["num_hidden_layers"]
    ffn = c["num_experts_per_tok"] * 3 * d * f + d * c["num_local_experts"]
    return L * (_attn_params(c) + ffn)


def attention_layers(c) -> int:
    return c["num_hidden_layers"]
