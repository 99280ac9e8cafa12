"""Model facade for the dense, moe and hybrid families (port of
`repro.models.model`).

`Model` is an `nn.Module` that holds its weights: the token embedding
(tied as the unembedding unless `cfg.tie_embeddings` is False), the final
norm, and in place of the reference's stacked `lax.scan` parameters
  dense   `blocks`: a `ModuleList` of dense blocks;
  moe     `blocks`: a `ModuleList` of MoE blocks (mixtral, arctic);
  hybrid  `mamba`: a `ModuleList` of `n_layers` Mamba2 layers, and
          `shared_attn`: ONE dense block applied after every `attn_every`
          Mamba2 layers, with its own KV cache per application (zamba2).
Layers run as a Python loop.

API (the reference's, with the parameters held by the module):
  Model(cfg, device=, seed=)                -> seeded truncated-normal init
  prefill(batch, W)                         -> (logits_last, cache, pos)
  decode_step(cache, token, pos)            -> (logits, cache)
  decode_loop(cache, token, pos, emitted, max_new, done, eos, sample_fn,
              n_tokens=K)                   -> K fused decode+sample steps
  init_cache(B, W)                          -> zeroed cache dict
  param_count(active_only=False)

The cache is a dict of tensors with the batch on axis 1, which decode
updates in place:
  dense, moe  {"k", "v"}: (L, B, W, K, hd); under a sliding window a ring
              of exactly `sliding_window` rows (slot = pos % W), seeded
              from the prefill's last W positions; with `kv_dtype="int8"`
              (and no window) int8 values plus {"ksc", "vsc"}: (L, B, W, K)
              bf16 scales, quantized after prefill;
  hybrid      {"conv": (L, B, k-1, cdim), "ssm": (L, B, H, P, N) float32,
              "k", "v": (L / attn_every, B, W, K, hd)}.
The ssm (xlstm), audio (whisper) and vlm (internvl2) families raise
NotImplementedError naming their ROADMAP item, as does training
(`loss`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._deferred import deferred
from repro_torch.models import attention, ssm, transformer as tfm
from repro_torch.models.common import dense_init, dtype_of, norm, \
    norm_init, param

_FAMILIES = "Queue 1 item 13b (the ssm, audio and vlm families)"
KV_FAMILIES = ("dense", "moe")


class Model(nn.Module):
    def __init__(self, cfg, *, device="cuda", seed=0):
        super().__init__()
        if cfg.family not in KV_FAMILIES + ("hybrid",):
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported to repro_torch "
                f"yet (ROADMAP {_FAMILIES})")
        self.cfg = cfg
        dev = torch.device(device)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        dt = dtype_of(cfg)
        self.embed = param(dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                      scale=0.02, device=dev))
        self.final_norm = norm_init(cfg, device=dev)
        if cfg.family == "hybrid":
            self.mamba = nn.ModuleList(ssm.init(gen, cfg, device=dev)
                                       for _ in range(cfg.n_layers))
            self.shared_attn = tfm.dense_block_init(gen, cfg, device=dev)
        else:
            block = tfm.moe_block_init if cfg.family == "moe" \
                else tfm.dense_block_init
            self.blocks = nn.ModuleList(block(gen, cfg, device=dev)
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
        """The cache's rows: a ring cache is always exactly
        `sliding_window` long (slot = pos % W and the prefill seeding
        assume it), else `seq_len`."""
        return self.cfg.sliding_window if self.cfg.sliding_window else seq_len

    def _int8_kv(self):
        """int8 KV cache: kv_dtype "int8" on a KV family without a ring
        (ring caches keep the working dtype, as in the reference)."""
        return (self.cfg.kv_dtype == "int8" and self.cfg.sliding_window == 0
                and self.cfg.family in KV_FAMILIES)

    def init_cache(self, B, W):
        cfg = self.cfg
        dt = dtype_of(cfg)
        K, hd, L = cfg.n_kv_heads, cfg.hd(), cfg.n_layers
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
        if cfg.family == "hybrid":
            di, nh, cdim = ssm.dims(cfg)
            napp = L // cfg.attn_every
            return {"conv": zeros((L, B, cfg.conv_kernel - 1, cdim), dt),
                    "ssm": zeros((L, B, nh, cfg.ssm_headdim, cfg.ssm_state),
                                 torch.float32),
                    "k": zeros((napp, B, W, K, hd), dt),
                    "v": zeros((napp, B, W, K, hd), dt)}
        W = self.kv_window(W)
        if self._int8_kv():
            return {"k": zeros((L, B, W, K, hd), torch.int8),
                    "v": zeros((L, B, W, K, hd), torch.int8),
                    "ksc": zeros((L, B, W, K), torch.bfloat16),
                    "vsc": zeros((L, B, W, K), torch.bfloat16)}
        return {name: zeros((L, B, W, K, hd), dt) for name in ("k", "v")}

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
        ring = cfg.sliding_window > 0

        def pad_kv(rows):
            # n x (B, S, K, hd) -> (n, B, W_eff, K, hd), zeros after S
            W_eff = self.kv_window(W or S)
            if W_eff < S:
                raise ValueError(f"cache window {W_eff} is shorter than "
                                 f"the prompt ({S} tokens)")
            out = rows[0].new_zeros((len(rows), B, W_eff) + rows[0].shape[2:])
            out[:, :, :S] = torch.stack(rows)
            return out

        ks, vs = [], []
        if cfg.family == "hybrid":
            per = cfg.attn_every
            convs, states = [], []
            for layer, mp in enumerate(self.mamba):
                y, cs, st = ssm.apply(mp, h, cfg, return_state=True)
                h = h + y
                convs.append(cs)
                states.append(st)
                if (layer + 1) % per == 0:
                    h, (k, v) = tfm.dense_block_prefill(
                        self.shared_attn, h, positions, cfg)
                    ks.append(k)
                    vs.append(v)
            cache = {"conv": torch.stack(convs), "ssm": torch.stack(states),
                     "k": pad_kv(ks), "v": pad_kv(vs)}
        else:
            for blk in self.blocks:
                if cfg.family == "moe":
                    h, (k, v), _ = tfm.moe_block_prefill(blk, h, positions,
                                                         cfg)
                else:
                    h, (k, v) = tfm.dense_block_prefill(blk, h, positions,
                                                        cfg)
                ks.append(k)
                vs.append(v)
            if ring:
                ck, cv = attention.seed_ring_cache(
                    torch.stack(ks), torch.stack(vs), cfg.sliding_window)
                cache = {"k": ck, "v": cv}
            elif self._int8_kv():
                kq, ksc = attention.quantize_kv(pad_kv(ks))
                vq, vsc = attention.quantize_kv(pad_kv(vs))
                cache = {"k": kq, "v": vq, "ksc": ksc, "vsc": vsc}
            else:
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
        if cfg.family == "hybrid":
            per = cfg.attn_every
            for layer, mp in enumerate(self.mamba):
                y, cs, st = ssm.decode_step(mp, x, cache["conv"][layer],
                                            cache["ssm"][layer], cfg)
                x = x + y
                cache["conv"][layer] = cs
                cache["ssm"][layer] = st
                if (layer + 1) % per == 0:
                    g = layer // per
                    x, _, _ = tfm.dense_block_decode(
                        self.shared_attn, x, cache["k"][g], cache["v"][g],
                        pos, cfg)
        else:
            ring = cfg.sliding_window > 0
            dec = tfm.moe_block_decode if cfg.family == "moe" \
                else tfm.dense_block_decode
            int8 = self._int8_kv()
            for layer, blk in enumerate(self.blocks):
                scales = ((cache["ksc"][layer], cache["vsc"][layer])
                          if int8 else None)
                out = dec(blk, x, cache["k"][layer], cache["v"][layer], pos,
                          cfg, ring=ring, scales=scales)
                x = out[0]
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
        """Number of weights; with `active_only`, the experts count at
        top_k / n_experts of their weights (the reference's formula)."""
        total = sum(p.numel() for p in self.parameters())
        cfg = self.cfg
        if active_only and cfg.n_experts:
            expert = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
            total = total - expert + expert * cfg.top_k // cfg.n_experts
        return total
