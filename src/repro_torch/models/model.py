"""Model facade for every family (port of `repro.models.model`).

`Model` is an `nn.Module` that holds its weights: the token embedding
(tied as the unembedding unless `cfg.tie_embeddings` is False), the final
norm, and in place of the reference's stacked `lax.scan` parameters
  dense   `blocks`: a `ModuleList` of dense blocks;
  vlm     `blocks` as dense; prefill prepends `batch["patches"]` (B, P, d)
          to the token embeddings, so positions and `pos` count the P
          patches (internvl2);
  moe     `blocks`: a `ModuleList` of MoE blocks (mixtral, arctic);
  hybrid  `mamba`: a `ModuleList` of `n_layers` Mamba2 layers, and
          `shared_attn`: ONE dense block applied after every `attn_every`
          Mamba2 layers, with its own KV cache per application (zamba2);
  ssm     `mlstm` (n_layers - n_layers // slstm_every mLSTM layers) and
          `slstm` (n_layers // slstm_every sLSTM layers), run in groups
          of slstm_every - 1 mLSTM layers and one sLSTM layer (xlstm);
  audio   `enc` (n_enc_layers encoder blocks) and `enc_norm` over
          `batch["frames"]` (B, F, d) plus sinusoidal positions, and `dec`
          (n_layers decoder blocks with cross-attention) over the tokens
          plus sinusoidal positions (whisper).
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
  dense, vlm, moe  {"k", "v"}: (L, B, W, K, hd); under a sliding window a
              ring of exactly `sliding_window` rows (slot = pos % W),
              seeded from the prefill's last W positions; with
              `kv_dtype="int8"` (and no window) int8 values plus {"ksc",
              "vsc"}: (L, B, W, K) bf16 scales, quantized after prefill;
  hybrid      {"conv": (L, B, k-1, cdim), "ssm": (L, B, H, P, N) float32,
              "k", "v": (L / attn_every, B, W, K, hd)};
  ssm         {"mconv": (n_m, B, 3, inner), "mC": (n_m, B, H, Dq, Dv),
              "mN": (n_m, B, H, Dq), "mM": (n_m, B, H), "sh", "sc", "sn",
              "sm": (n_s, B, d)}, the states float32, mM and sm from -1e30;
  audio       {"k", "v": (L, B, W, K, hd), "xk", "xv": (L, B, F, K, hd)},
              the encoder's K/V per decoder layer, written by prefill.
Training (`loss`) raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._deferred import deferred
from repro_torch.models import attention, ssm, transformer as tfm, xlstm
from repro_torch.models.common import dense_init, dtype_of, norm, \
    norm_init, param, sinusoid_at, sinusoidal_positions

KV_FAMILIES = ("dense", "vlm", "moe")
FAMILIES = KV_FAMILIES + ("hybrid", "ssm", "audio")


def xlstm_depths(cfg):
    """(mLSTM layers, sLSTM layers) of the ssm family: one sLSTM layer
    per group of `slstm_every`."""
    n_s = cfg.n_layers // cfg.slstm_every
    return cfg.n_layers - n_s, n_s


class Model(nn.Module):
    def __init__(self, cfg, *, device="cuda", seed=0):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
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
        elif cfg.family == "ssm":
            n_m, n_s = xlstm_depths(cfg)
            self.mlstm = nn.ModuleList(xlstm.m_init(gen, cfg, device=dev)
                                       for _ in range(n_m))
            self.slstm = nn.ModuleList(xlstm.s_init(gen, cfg, device=dev)
                                       for _ in range(n_s))
        elif cfg.family == "audio":
            self.enc = nn.ModuleList(tfm.enc_block_init(gen, cfg, device=dev)
                                     for _ in range(cfg.n_enc_layers))
            self.enc_norm = norm_init(cfg, device=dev)
            self.dec = nn.ModuleList(tfm.xdec_block_init(gen, cfg, device=dev)
                                     for _ in range(cfg.n_layers))
        else:
            block = tfm.moe_block_init if cfg.family == "moe" \
                else tfm.dense_block_init
            self.blocks = nn.ModuleList(block(gen, cfg, device=dev)
                                        for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = param(dense_init(
                gen, (cfg.d_model, cfg.vocab_size), dt, device=dev))

    loss = deferred("models.model.Model.loss", "Queue 1 item 13c (training)")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # what a server needs to know of the family
    # ------------------------------------------------------------------
    @property
    def prefix_rows(self) -> int:
        """Cache rows and positions that prefill puts before the prompt:
        the vlm family's patch embeddings."""
        return self.cfg.n_patches if self.cfg.family == "vlm" else 0

    @property
    def rows_bounded(self) -> bool:
        """Whether each position takes a row of a `W`-row cache, so that
        W bounds a request: not under a ring (it wraps), nor in the ssm
        family (its state has no rows)."""
        return self.cfg.family != "ssm" and not self.cfg.sliding_window

    def stub_inputs(self, B: int) -> dict:
        """The prefill inputs of the stub frontends for a batch of B, zeros
        in the working dtype as the reference engine makes them: the audio
        family's `frames` (B, F, d), the vlm family's `patches` (B, P, d)."""
        cfg = self.cfg
        n = {"audio": ("frames", cfg.enc_frames),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
        if n is None:
            return {}
        return {n[0]: torch.zeros((B, n[1], cfg.d_model),
                                  dtype=self.embed.dtype, device=self.device)}

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
        if cfg.family == "ssm":
            inner, nh, hq, hv = xlstm.m_dims(cfg)
            n_m, n_s = xlstm_depths(cfg)
            f32 = torch.float32
            full = lambda shape: torch.full(shape, -1e30, dtype=f32,
                                            device=self.device)
            return {"mconv": zeros((n_m, B, 3, inner), dt),
                    "mC": zeros((n_m, B, nh, hq, hv), f32),
                    "mN": zeros((n_m, B, nh, hq), f32),
                    "mM": full((n_m, B, nh)),
                    "sh": zeros((n_s, B, cfg.d_model), f32),
                    "sc": zeros((n_s, B, cfg.d_model), f32),
                    "sn": zeros((n_s, B, cfg.d_model), f32),
                    "sm": full((n_s, B, cfg.d_model))}
        if cfg.family == "audio":
            nf = cfg.enc_frames
            return {"k": zeros((L, B, W, K, hd), dt),
                    "v": zeros((L, B, W, K, hd), dt),
                    "xk": zeros((L, B, nf, K, hd), dt),
                    "xv": zeros((L, B, nf, K, hd), dt)}
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
        if cfg.family == "vlm":
            h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
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
        elif cfg.family == "ssm":
            h, cache = self._xlstm_prefill(h)
        elif cfg.family == "audio":
            enc_out = self._encode(batch["frames"])
            h = h + sinusoidal_positions(S, cfg.d_model,
                                         h.device).to(h.dtype)[None]
            xks, xvs = [], []
            for blk in self.dec:
                h, (k, v), (xk, xv) = tfm.xdec_block_apply(
                    blk, h, enc_out, positions, cfg)
                ks.append(k)
                vs.append(v)
                xks.append(xk)
                xvs.append(xv)
            cache = {"k": pad_kv(ks), "v": pad_kv(vs),
                     "xk": torch.stack(xks), "xv": torch.stack(xvs)}
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

    def _encode(self, frames):
        """The audio encoder: frames (B, F, d) plus sinusoidal positions
        through the bidirectional encoder blocks, then `enc_norm`."""
        cfg = self.cfg
        e = frames.to(dtype_of(cfg))
        e = e + sinusoidal_positions(e.shape[1], cfg.d_model,
                                     e.device).to(e.dtype)[None]
        for blk in self.enc:
            e = tfm.enc_block_apply(blk, e, cfg)
        return norm(e, self.enc_norm, cfg)

    def _xlstm_groups(self):
        """(mLSTM layer indices, sLSTM index) of each group."""
        per = self.cfg.slstm_every - 1
        return [(range(g * per, (g + 1) * per), g)
                for g in range(len(self.slstm))]

    def _xlstm_prefill(self, h):
        convs, Cs, ns, ms, sstates = [], [], [], [], []
        for mls, g in self._xlstm_groups():
            for i in mls:
                y, (cs, (C, n, m)) = xlstm.m_apply(self.mlstm[i], h, self.cfg,
                                                   return_state=True)
                h = h + y
                convs.append(cs)
                Cs.append(C)
                ns.append(n)
                ms.append(m)
            y, st = xlstm.s_apply(self.slstm[g], h, self.cfg,
                                  return_state=True)
            h = h + y
            sstates.append(st)
        cache = {"mconv": torch.stack(convs), "mC": torch.stack(Cs),
                 "mN": torch.stack(ns), "mM": torch.stack(ms)}
        for j, name in enumerate(("sh", "sc", "sn", "sm")):
            cache[name] = torch.stack([st[j] for st in sstates])
        return h, cache

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
        elif cfg.family == "ssm":
            for mls, g in self._xlstm_groups():
                for i in mls:
                    y, hist, (C, n, m) = xlstm.m_decode(
                        self.mlstm[i], x, cache["mconv"][i],
                        (cache["mC"][i], cache["mN"][i], cache["mM"][i]), cfg)
                    x = x + y
                    cache["mconv"][i] = hist
                    cache["mC"][i], cache["mN"][i], cache["mM"][i] = C, n, m
                y, st = xlstm.s_decode(
                    self.slstm[g], x, tuple(cache[name][g] for name in
                                            ("sh", "sc", "sn", "sm")), cfg)
                x = x + y
                for name, t in zip(("sh", "sc", "sn", "sm"), st):
                    cache[name][g] = t
        elif cfg.family == "audio":
            x = x + sinusoid_at(pos, cfg.d_model).to(x.dtype)
            for layer, blk in enumerate(self.dec):
                x, _, _ = tfm.xdec_block_decode(
                    blk, x, cache["k"][layer], cache["v"][layer],
                    cache["xk"][layer], cache["xv"][layer], pos, cfg)
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
