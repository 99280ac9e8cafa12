"""Deterministic synthetic LM data pipeline (port of
`repro.data.pipeline`, a numpy copy of it).

An infinite, sharded, resumable stream: every batch is a pure function
of (seed, step, shard), so a restart resumes at the step cursor and
reproduces the same batches. Sequences are Zipf-distributed token ids
with a deterministic successor structure (token t+1 = 31 t + 7 mod V
with probability 0.7), so a model has signal to learn; labels are the
next token. The audio family also gets `frames` (B, enc_frames, d) and
the vlm family `patches` (B, n_patches, d) as float32 normals, and the
vlm's tokens and labels are cut to seq_len - n_patches, so patches plus
tokens fill the sequence.

Batches are numpy arrays, equal bit for bit to the reference's at any
(seed, step, shard); the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    family: str = "dense"
    d_model: int = 0
    enc_frames: int = 0
    n_patches: int = 0

    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> dict:
        """The (step, shard) batch: a pure function, O(1) random access."""
        lb = self.local_batch()
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        V = self.vocab_size
        base = rng.zipf(1.3, size=(lb, self.seq_len + 1)) % V
        succ = (base[:, :-1] * 31 + 7) % V
        mix = rng.random((lb, self.seq_len)) < 0.7
        toks = np.where(mix, succ, base[:, 1:]).astype(np.int32)
        first = base[:, :1].astype(np.int32)
        seq = np.concatenate([first, toks], axis=1)       # (lb, S + 1)
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if self.family == "audio":
            out["frames"] = rng.standard_normal(
                (lb, self.enc_frames, self.d_model)).astype(np.float32)
        if self.family == "vlm":
            n = self.n_patches
            out["tokens"] = out["tokens"][:, : self.seq_len - n]
            out["labels"] = out["labels"][:, : self.seq_len - n]
            out["patches"] = rng.standard_normal(
                (lb, n, self.d_model)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_iterator(cfg, shape, *, seed=0, n_shards=1, shard=0,
                        start_step=0):
    """(dataset, iterator from `start_step`) for a model config and a
    `ShapeConfig` (its seq_len and global_batch)."""
    ds = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed, n_shards=n_shards,
        shard=shard, family=cfg.family, d_model=cfg.d_model,
        enc_frames=cfg.enc_frames, n_patches=cfg.n_patches)
    return ds, ds.iterate(start_step)
