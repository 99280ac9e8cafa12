"""Plain float32 reference of the mixtral decoder (Mixtral-8x7B's layer
equations, arXiv:2401.04088), one sequence at a time, layer by layer.

Per layer: h += Attn(rms_norm(h)), with grouped-query attention, the
half-split rotary embedding, causal over the whole sequence (a sliding
window if the configuration sets one); then h += MoE(rms_norm(h)): a
float32 router, softmax over the experts, the top `num_experts_per_tok`
by probability (ties to the lower expert), renormalized gates, and each
chosen expert's SwiGLU, dropless. Then the final rms_norm and the
unembedding.

The weights are the harness's dict (`layout` names them); each layer's
are cast to float32 when that layer runs, so the float32 copy of one
layer is all the extra memory it takes.
"""
from __future__ import annotations

import torch

from perfbench.reference.common import attention, full_precision, mm, \
    rms_norm, rope


def layout(c) -> list:
    """(name, shape, dtype, role, fan_in) of every weight, in the harness's
    naming. Roles: "embed", "in" (an input projection), "out" (a residual
    branch's output projection), "router", "ones" (`harness.weights`)."""
    d, f, H, K = c["hidden_size"], c["intermediate_size"], \
        c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // H
    E, V = c["num_local_experts"], c["vocab_size"]
    bf, f32 = torch.bfloat16, torch.float32
    out = [("embed", (V, d), bf, "embed", d)]
    for l in range(c["num_hidden_layers"]):
        p = f"blocks.{l}."
        out += [(p + "n1.scale", (d,), bf, "ones", d),
                (p + "attn.wq", (d, H, hd), bf, "in", d),
                (p + "attn.wk", (d, K, hd), bf, "in", d),
                (p + "attn.wv", (d, K, hd), bf, "in", d),
                (p + "attn.wo", (H, hd, d), bf, "out", H * hd),
                (p + "n2.scale", (d,), bf, "ones", d),
                (p + "moe.router", (d, E), f32, "router", d),
                (p + "moe.w1", (E, d, f), bf, "in", d),
                (p + "moe.w3", (E, d, f), bf, "in", d),
                (p + "moe.w2", (E, f, d), bf, "out", f)]
    out += [("final_norm.scale", (d,), bf, "ones", d),
            ("unembed", (d, V), bf, "in", d)]
    return out


def residual_branches(c) -> int:
    """Residual branches the output projections feed: attention and MoE
    in every layer."""
    return 2 * c["num_hidden_layers"]


def _weights(w, l):
    p = f"blocks.{l}."
    return lambda n: w[p + n].float()  # noqa: E731


def attention_block(c, w, l, h, positions, precision="fp32"):
    """h + Attn(rms_norm(h)) of layer l."""
    g = _weights(w, l)
    d, H, K = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    hd = d // H
    x = rms_norm(h, g("n1.scale"), c["rms_norm_eps"])
    q = mm(x, g("attn.wq").reshape(d, H * hd), precision).view(-1, H, hd)
    k = mm(x, g("attn.wk").reshape(d, K * hd), precision).view(-1, K, hd)
    v = mm(x, g("attn.wv").reshape(d, K * hd), precision).view(-1, K, hd)
    q = rope(q, positions, c["rope_theta"])
    k = rope(k, positions, c["rope_theta"])
    o = attention(q, k, v, window=c.get("sliding_window") or 0)
    return h + mm(o.reshape(-1, H * hd), g("attn.wo").reshape(H * hd, d),
                  precision)


def router_probs(c, w, l, h):
    """The router's probabilities (T, E) of layer l for the hidden state
    after its attention."""
    g = _weights(w, l)
    x = rms_norm(h, g("n2.scale"), c["rms_norm_eps"])
    return torch.softmax(x @ g("moe.router"), dim=-1)


def moe_block(c, w, l, h, precision="fp32"):
    """h + MoE(rms_norm(h)) of layer l."""
    g = _weights(w, l)
    x = rms_norm(h, g("n2.scale"), c["rms_norm_eps"])
    # the bf16 witness routes on the normed state rounded to bf16, as a
    # bf16 model's router sees it (its product stays float32)
    xr = x.to(torch.bfloat16).float() if precision == "bf16" else x
    probs = torch.softmax(xr @ g("moe.router"), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k_top = c["num_experts_per_tok"]
    gates, idx = gates[:, :k_top], idx[:, :k_top]
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    w1, w3, w2 = g("moe.w1"), g("moe.w3"), g("moe.w2")
    for e in range(c["num_local_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = torch.nn.functional.silu(mm(xe, w1[e], precision)) \
            * mm(xe, w3[e], precision)
        y.index_add_(0, tok, mm(he, w2[e], precision)
                     * gates[tok, slot][:, None])
    return h + y


@torch.no_grad()
def logits(c, w, tokens: torch.Tensor, rows: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """float32 logits (len(rows), V) at positions `rows` of one sequence
    `tokens` (T,) int, on the weights' device."""
    with full_precision():
        positions = torch.arange(tokens.shape[0], device=tokens.device)
        h = w["embed"][tokens.long()].float()
        for l in range(c["num_hidden_layers"]):
            h = attention_block(c, w, l, h, positions, precision)
            h = moe_block(c, w, l, h, precision)
        h = rms_norm(h[rows], w["final_norm.scale"].float(),
                     c["rms_norm_eps"])
        return mm(h, w["unembed"].float(), precision)
