"""Naive oracle for the flash-attention kernel (port of
`repro.kernels.flash_attention.ref`): causal GQA attention with the whole
(Sq, Skv) score matrix materialized."""
import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, q_offset=0):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s / math.sqrt(hd)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= qpos[:, None]
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", w, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
