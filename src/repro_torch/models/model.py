"""Model facade for the dense decoder family (port of
`repro.models.model`).

`Model` is an `nn.Module` that holds its weights: the token embedding
(tied as the unembedding unless `cfg.tie_embeddings` is False), a
`ModuleList` of dense blocks in place of the reference's stacked
`lax.scan` parameters, and the final norm. Layers run as a Python loop.

API (the reference's, with the parameters held by the module):
  Model(cfg, device=, seed=)                -> seeded truncated-normal init
  prefill(batch, W)                         -> (logits_last, cache, pos)
  decode_step(cache, token, pos)            -> (logits, cache)
  decode_loop(cache, token, pos, emitted, max_new, done, eos, sample_fn,
              n_tokens=K)                   -> K fused decode+sample steps
  init_cache(B, W)                          -> zeroed cache dict
  param_count(active_only=False)

The cache is {"k", "v"}: (L, B, W, K, hd) tensors that decode updates in
place. Other families (vlm, moe, hybrid, ssm, audio), the int8 KV cache
and sliding-window attention raise NotImplementedError naming their
ROADMAP item, as does training (`loss`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._deferred import deferred
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dense_init, dtype_of, norm, \
    norm_init, param

_FAMILIES = "Queue 1 item 13 (model families beyond dense)"


class Model(nn.Module):
    def __init__(self, cfg, *, device="cuda", seed=0):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported to repro_torch "
                f"yet (ROADMAP {_FAMILIES})")
        if cfg.kv_dtype == "int8" or cfg.sliding_window > 0:
            raise NotImplementedError(
                "int8 KV caches and sliding-window attention are not ported "
                "to repro_torch yet (ROADMAP Queue 1 item 13)")
        self.cfg = cfg
        dev = torch.device(device)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        dt = dtype_of(cfg)
        self.embed = param(dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                      scale=0.02, device=dev))
        self.final_norm = norm_init(cfg, device=dev)
        self.blocks = nn.ModuleList(tfm.dense_block_init(gen, cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = param(dense_init(
                gen, (cfg.d_model, cfg.vocab_size), dt, device=dev))

    loss = deferred("models.model.Model.loss", "Queue 1 item 13 (training)")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # embedding helpers
    # ------------------------------------------------------------------
    def _embed(self, tokens):
        return F.embedding(tokens, self.embed)

    def _unembed_w(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _logits_last(self, h_last):
        """h_last: (B, d) -> (B, V) float32: float32 sums of the working
        dtype's products, as the reference's preferred_element_type."""
        return h_last.float() @ self._unembed_w().float()

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def kv_window(self, seq_len):
        return self.cfg.sliding_window if self.cfg.sliding_window else seq_len

    def init_cache(self, B, W):
        cfg = self.cfg
        shape = (cfg.n_layers, B, self.kv_window(W), cfg.n_kv_heads, cfg.hd())
        return {name: torch.zeros(shape, dtype=dtype_of(cfg),
                                  device=self.device) for name in ("k", "v")}

    # ------------------------------------------------------------------
    # prefill: full forward that also builds the cache; returns logits of
    # the last position. W (cache window) == padded cache length.
    # ------------------------------------------------------------------
    def prefill(self, batch, W=None):
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        h = self._embed(tokens)
        S = h.shape[1]
        positions = torch.arange(S, device=h.device).expand(B, S)
        ks, vs = [], []
        for blk in self.blocks:
            h, (k, v) = tfm.dense_block_prefill(blk, h, positions, cfg)
            ks.append(k)
            vs.append(v)
        W_eff = self.kv_window(W or S)
        if W_eff < S:
            raise ValueError(f"cache window {W_eff} is shorter than the "
                             f"prompt ({S} tokens)")

        def pad_kv(rows):
            # L x (B, S, K, hd) -> (L, B, W_eff, K, hd), zeros after S
            out = rows[0].new_zeros((len(rows), B, W_eff) + rows[0].shape[2:])
            out[:, :, :S] = torch.stack(rows)
            return out

        cache = {"k": pad_kv(ks), "v": pad_kv(vs)}
        h = norm(h, self.final_norm, cfg)
        logits = self._logits_last(h[:, -1])
        pos = torch.full((B,), S, dtype=torch.int32, device=h.device)
        return logits, cache, pos

    # ------------------------------------------------------------------
    # decode: one token against the cache
    # ------------------------------------------------------------------
    def decode_step(self, cache, token, pos):
        """token: (B, 1) int32; pos: (B,) int32. Returns (logits, cache),
        the cache updated in place."""
        cfg = self.cfg
        x = self._embed(token)
        for layer, blk in enumerate(self.blocks):
            x, _, _ = tfm.dense_block_decode(blk, x, cache["k"][layer],
                                             cache["v"][layer], pos, cfg)
        h = norm(x, self.final_norm, cfg)
        return self._logits_last(h[:, -1]), cache

    # ------------------------------------------------------------------
    # decode loop: K decode+sample steps per dispatch, no host sync
    # ------------------------------------------------------------------
    def decode_loop(self, cache, token, pos, emitted, max_new, done, eos,
                    sample_fn, *, n_tokens):
        """`n_tokens` decode steps with per-slot stop state.

        token: (B, 1) int32 feedback tokens; pos / emitted / max_new /
        eos: (B,) int32 (eos < 0 means "no stop token"); done: (B,) bool;
        sample_fn(logits) -> (B,) int32 (the engine closes it over the
        per-slot temperature / top-k and its torch.Generator).

        Finished slots freeze: their pos/emitted stop advancing and their
        feedback token is fed again, so the repeated cache write at the
        frozen position is idempotent. Returns (cache, token, pos,
        emitted, done, toks, live) with toks and live shaped (n_tokens,
        B): token k belongs to slot b's stream iff live[k, b] (a prefix
        mask, since slots freeze monotonically).
        """
        toks, lives = [], []
        for _ in range(n_tokens):
            logits, cache = self.decode_step(cache, token, pos)
            tok = sample_fn(logits)
            live = ~done
            tok = torch.where(live, tok, token[:, 0]).to(torch.int32)
            inc = live.to(torch.int32)
            emitted = emitted + inc
            pos = pos + inc
            done = done | (emitted >= max_new) | (live & (eos >= 0)
                                                  & (tok == eos))
            token = tok[:, None]
            toks.append(tok)
            lives.append(live)
        return (cache, token, pos, emitted, done, torch.stack(toks),
                torch.stack(lives))

    # ------------------------------------------------------------------
    # counting
    # ------------------------------------------------------------------
    def param_count(self, active_only=False) -> int:
        """Number of weights (the dense family has no inactive experts)."""
        return sum(p.numel() for p in self.parameters())
