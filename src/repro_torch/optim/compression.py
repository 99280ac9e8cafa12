"""Gradient compression: int8 blocks with an error-feedback residual
(port of `repro.optim.compression`).

Each leaf, plus its carried residual, is flattened, zero-padded to whole
blocks of `BLOCK` values and quantized symmetrically per block: scale =
max(|block|, 1e-12) / 127, q = clip(round(x / scale), -127, 127) as int8
(round half to even, as jnp.round). The residual is what the
quantization lost, carried into the next step's gradient (EF-SGD), so
the compressed fixed point matches the uncompressed one. Wire cost: 8
bits plus one float32 scale per block against 32 bits a value.

    cgrads, err = compress_grads(grads, err)
    grads = decompress_grads(cgrads)

Trees are nested dicts (or lists/tuples) of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import tree_map

BLOCK = 1024
F32 = torch.float32


class Compressed(NamedTuple):
    q: torch.Tensor        # (n_blocks, BLOCK) int8
    scale: torch.Tensor    # (n_blocks,) float32
    shape: tuple
    n: int


def _compress_one(g, e):
    g32 = g.to(F32) + (e if e is not None else 0.0)
    flat = g32.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    fb = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp_min(fb.abs().amax(dim=1), 1e-12) / fb.new_tensor(
        127.0)
    q = torch.clamp(torch.round(fb / scale[:, None]), -127, 127).to(
        torch.int8)
    deq = (q.to(F32) * scale[:, None]).reshape(-1)[:n]
    err = (flat - deq).reshape(g.shape)
    return Compressed(q, scale, tuple(g.shape), n), err


def compress_grads(grads, err_tree=None):
    """(tree of `Compressed`, tree of float32 residuals) for a gradient
    tree and the residuals carried from the last step (zeros if None)."""
    if err_tree is None:
        err_tree = tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                              device=g.device), grads)
    out = tree_map(_compress_one, grads, err_tree)
    is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 \
        and isinstance(x[0], Compressed)  # noqa: E731
    return (tree_map(lambda o: o[0], out, leaf=is_pair),
            tree_map(lambda o: o[1], out, leaf=is_pair))


def decompress_grads(comp):
    """The float32 gradient tree of a tree of `Compressed`."""
    def one(c: Compressed):
        deq = (c.q.to(F32) * c.scale[:, None]).reshape(-1)[:c.n]
        return deq.reshape(c.shape)
    return tree_map(one, comp, leaf=lambda x: isinstance(x, Compressed))


def wire_bytes_ratio() -> float:
    """float32 bytes / compressed bytes per value."""
    return 4.0 / (1.0 + 4.0 / BLOCK)
