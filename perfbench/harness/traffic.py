"""The one general traffic generator: it reads a traffic file's parameters
and the run's seed and makes the requests or batches.

Serve mixes (kind "serve") are open loops: requests arrive at
`rate_per_s` over the window. The request sizes and the gaps between
arrivals are quantiles of the stated distributions, put in one fixed
order (`ORDER`), so every seed offers the same work at the same times: a
seed's order of long prompts would move the latency tails far more than
the program's own noise does. The seed draws the token ids (and the
weights).
"""
from __future__ import annotations

import dataclasses

import numpy as np


# the fixed order of a serve mix's sizes and arrival gaps
ORDER = 0x5EB0


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles of the spec's distribution."""
    u = _quantiles(n)
    if spec["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        v = spec["min"] + u * (spec["max"] - spec["min"] + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    v = np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)
    m = spec.get("multiple", 1)
    if m > 1:
        v = np.maximum((v + m - 1) // m * m, m)
    return v


@dataclasses.dataclass
class ServeRequest:
    index: int
    due_s: float            # arrival, seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    max_new: int


def serve_schedule(mix: dict, seed: int, seconds: float,
                   vocab: int) -> list:
    """The requests due in a window of `seconds`, in arrival order."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    order = np.random.default_rng(ORDER)
    prompts = order.permutation(_lengths(mix["prompt"], n))
    outs = order.permutation(_lengths(mix["output"], n))
    gaps = -np.log1p(-_quantiles(n)) / mix["rate_per_s"]   # exponential
    gaps = order.permutation(gaps) * (seconds / max(gaps.sum(), 1e-9))
    rng = np.random.default_rng([int(seed), 0x5EB])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    reqs = []
    for i in range(n):
        toks = rng.integers(0, vocab, size=int(prompts[i]), dtype=np.int64)
        reqs.append(ServeRequest(i, float(due[i]), toks.astype(np.int32),
                                 int(outs[i])))
    return reqs


def check_sample(reqs: list, mix: dict, seed: int) -> list:
    """Indices of the finished requests the correctness check compares:
    the longest prompt, then others drawn from the seed until the sample
    holds `check_tokens` served tokens."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    order = sorted(range(len(reqs)), key=lambda i: -len(reqs[i].prompt))
    pick = [order[0]]
    rest = [int(i) for i in rng.permutation(order[1:])]
    served = reqs[order[0]].max_new
    for i in rest:
        if served >= mix["check_tokens"]:
            break
        pick.append(i)
        served += reqs[i].max_new
    return pick
