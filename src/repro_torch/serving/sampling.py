"""Samplers for the serving engine (port of `repro.serving.sampling`).

`sample_tokens` is the device sampler of the decode loop: greedy where
temperature <= 0, otherwise top-k temperature sampling (`torch.topk`,
then a categorical draw by the Gumbel-max rule from an explicit
`torch.Generator`), batched over slots with no host sync.

`sample_host` is the per-request host sampler, kept as the parity
reference and as the sampling path of the engine's ``mode="host"``
per-token loop; it is the reference's numpy code, so one
`np.random.Generator` state gives the same token in both packages. The
two samplers are equal under greedy decoding; under temperature sampling
they draw from the same top-k support but from different random streams.
"""
from __future__ import annotations

import numpy as np
import torch


def sample_tokens(logits, generator, temperature, top_k, *, k_max: int):
    """Sample one token per row, on the logits' device.

    logits: (B, V) float32; temperature: (B,) float32; top_k: (B,) int32.
    `k_max` is the fixed top-k width; per-row `top_k` is clipped into
    [1, k_max] by masking the tail of the top-k candidates.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    k_max = min(int(k_max), logits.shape[-1])
    vals, idx = torch.topk(logits, k_max, dim=-1)           # (B, k_max)
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    keep = (torch.arange(k_max, device=logits.device)[None, :]
            < torch.clamp(top_k, 1, k_max)[:, None])
    scaled = torch.where(keep, vals / t, -torch.inf)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    choice = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idx, -1, choice[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled.to(torch.int32), greedy)


def sample_host(logits: np.ndarray, temperature: float, top_k: int,
                rng: np.random.Generator) -> int:
    """Host reference sampler: one token from one row of logits."""
    if temperature <= 0:
        return int(np.argmax(logits))
    l = logits / temperature
    idx = np.argpartition(l, -top_k)[-top_k:]
    p = np.exp(l[idx] - l[idx].max())
    p /= p.sum()
    return int(rng.choice(idx, p=p))
