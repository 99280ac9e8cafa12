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
  Model(cfg, ..., mesh=, rules=)            -> the same weights as DTensors
                                               on a DeviceMesh
  param_specs(), cache_specs()              -> the reference's logical-axis
                                               trees
  loss(batch, params=None)                  -> (loss, {"ce", "aux"})
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

Under a mesh (`launch.steps.build` makes it) each weight is a DTensor
placed by the rules over `param_specs` (a stacked leaf's spec less its
layer axis), and `prefill`, `decode_step` and `loss` run in the sharding
context (`models.common.sharding_ctx`), where plain tensors count as
replicated. Every family runs on a mesh: the moe FFN through its own
expert- and tensor-parallel paths (`models.moe`), the others through
their layouts alone (weights placed by `param_specs`, activations by
`shard_act`), as in the reference; the ssm family's sLSTM scan runs per
rank (`xlstm.s_apply`).

Training: `loss` runs the train-mode forward of every family (the
reference's `Model.loss`), differentiably. `params`, if given, is the
reference's STACKED parameter tree (`param_tree`: "embed",
"final_norm", ["unembed"], and the layer stacks "blocks", "mamba" plus
"shared_attn", "mlstm" and "slstm", or "enc", "enc_norm" and "dec", every
stacked leaf with its leading layer axis), used in place of the module's
own weights: the trainer passes its float32 master cast to the working
dtype, and gradients flow back to that tree (each stack is unbound into
its layers once, so a stack's gradient is gathered in one stack op).
`cfg.remat` checkpoints as the reference's `_remat`: "full" each block
under `torch.utils.checkpoint` (non-reentrant), "dots" the same keeping
the 2-D matrix products' outputs, "none" nothing; the blocks it wraps
are the reference's scan bodies (in the hybrid and ssm families the
Mamba2 and mLSTM layers, not the shared attention block or the sLSTM).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, ssm, transformer as tfm, xlstm
from repro_torch.models.common import chunked_softmax_xent, \
    current_mesh, dense_init, dtype_of, embed, gathered, logical_to_pspec, \
    norm, norm_init, norm_specs, param, shard_act, sharding_ctx, \
    sinusoid_at, sinusoidal_positions, to_placements

KV_FAMILIES = ("dense", "vlm", "moe")
FAMILIES = KV_FAMILIES + ("hybrid", "ssm", "audio")


def xlstm_depths(cfg):
    """(mLSTM layers, sLSTM layers) of the ssm family: one sLSTM layer
    per group of `slstm_every`."""
    n_s = cfg.n_layers // cfg.slstm_every
    return cfg.n_layers - n_s, n_s


def stack_depths(cfg) -> dict:
    """The layer stacks of the config's family and their depths:
    "blocks" (dense, vlm, moe), "mamba" (hybrid; its "shared_attn" is
    not stacked), "mlstm" and "slstm" (ssm), "enc" and "dec" (audio)."""
    fam = cfg.family
    if fam == "hybrid":
        return {"mamba": cfg.n_layers}
    if fam == "ssm":
        n_m, n_s = xlstm_depths(cfg)
        return {"mlstm": n_m, "slstm": n_s}
    if fam == "audio":
        return {"enc": cfg.n_enc_layers, "dec": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def _nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for name, v in flat.items():
        *head, last = name.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def param_tree(model, dtype=None) -> dict:
    """The model's parameters as the reference's stacked tree of tensors
    (copies), in `dtype` if given, else each parameter's own dtype, on
    the model's device (a meta model gives meta tensors: shapes only)."""
    depths = stack_depths(model.cfg)
    named = dict(model.named_parameters())
    flat = {}
    for name, p in named.items():
        stack, *rest = name.split(".")
        if stack in depths:
            if rest[0] != "0":
                continue
            key = ".".join(rest[1:])
            t = torch.stack([named[f"{stack}.{i}.{key}"].detach()
                             for i in range(depths[stack])])
            flat[f"{stack}.{key}"] = t if dtype is None else t.to(dtype)
        else:
            flat[name] = p.detach().to(dtype or p.dtype, copy=True)
    return _nest(flat)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products with no
    batch dimension (the reference's checkpoint_dots_with_no_batch_dims),
    recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode):
    """`fn` checkpointed as `cfg.remat` says: "full" recomputes the whole
    block in the backward, "dots" keeps the matrix products' outputs,
    "none" (or anything else) saves as autograd does."""
    if mode == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_matmuls)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return fn


class _View:
    """Attribute access to a dict of tensors (one layer's slice of a
    stacked tree, or an unstacked part of it), as the blocks read a
    module's parameters."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, _View(v) if isinstance(v, dict) else v)


def _unstack(tree, n):
    """A stacked dict tree -> n per-layer `_View`s (each leaf unbound
    along its leading layer axis once)."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [_View({k: p[i] for k, p in parts.items()}) for i in range(n)]


class _Weights:
    """The weights `loss` reads, from a stacked tree: the same attribute
    names as the module ("embed", "final_norm", "blocks", ...), the
    stacks as lists of per-layer views."""

    def __init__(self, cfg, tree):
        depths = stack_depths(cfg)
        for k, v in tree.items():
            depth = depths.get(k)
            setattr(self, k, _unstack(v, depth) if depth is not None
                    else _View(v) if isinstance(v, dict) else v)


def _add_layer_axis(tree):
    return {k: (_add_layer_axis(v) if isinstance(v, dict)
                else ("layers",) + tuple(v)) for k, v in tree.items()}


def param_specs(cfg) -> dict:
    """The logical-axis tree of the stacked parameter tree (the
    reference's `Model.param_specs`)."""
    p = {"embed": ("vocab", "embed_fsdp"), "final_norm": norm_specs(cfg)}
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed_fsdp", "vocab")
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["blocks"] = _add_layer_axis(tfm.dense_block_specs(cfg))
    elif fam == "moe":
        p["blocks"] = _add_layer_axis(tfm.moe_block_specs(cfg))
    elif fam == "hybrid":
        p["mamba"] = _add_layer_axis(ssm.specs(cfg))
        p["shared_attn"] = tfm.dense_block_specs(cfg)
    elif fam == "ssm":
        p["mlstm"] = _add_layer_axis(xlstm.m_specs(cfg))
        p["slstm"] = _add_layer_axis(xlstm.s_specs(cfg))
    elif fam == "audio":
        p["enc"] = _add_layer_axis(tfm.enc_block_specs(cfg))
        p["enc_norm"] = norm_specs(cfg)
        p["dec"] = _add_layer_axis(tfm.xdec_block_specs(cfg))
    return p


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class Model(nn.Module):
    def __init__(self, cfg, *, device="cuda", seed=0, mesh=None,
                 rules=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and rules is None:
            from repro_torch.launch.sharding import make_rules
            rules = make_rules(mesh)
        self.rules = rules
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
        if mesh is not None:
            self._place()

    def _place(self):
        """Every weight as a DTensor on the mesh, placed by the rules over
        `param_specs` (a stacked leaf's spec less its layer axis, which
        the rules never shard); each rank keeps its own slice of the
        weights it made from the seed, so nothing is sent."""
        from torch.distributed.tensor import distribute_tensor
        specs = self.param_specs()
        depths = stack_depths(self.cfg)
        for name, p in list(self.named_parameters()):
            head, *rest = name.split(".")
            if head in depths:
                axes = _leaf(specs, [head] + rest[1:])
                shape = (depths[head],) + tuple(p.shape)
                spec = logical_to_pspec(axes, self.rules, shape=shape,
                                        mesh=self.mesh)[1:]
            else:
                axes = _leaf(specs, name.split("."))
                spec = logical_to_pspec(axes, self.rules, shape=p.shape,
                                        mesh=self.mesh)
            t = distribute_tensor(p.detach(), self.mesh,
                                  to_placements(spec, self.mesh),
                                  src_data_rank=None)
            owner = self.get_submodule(name.rpartition(".")[0]) \
                if "." in name else self
            setattr(owner, name.rpartition(".")[2], param(t))

    def _ctx(self):
        """The sharding context of this model's mesh and rules, where plain
        tensors (positions, masks) count as replicated; nothing without a
        mesh or inside the context already (torch's implicit_replication
        does not nest)."""
        if self.mesh is None or current_mesh() is self.mesh:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        stack = contextlib.ExitStack()
        stack.enter_context(sharding_ctx(self.mesh, self.rules))
        stack.enter_context(implicit_replication())
        return stack

    def param_specs(self) -> dict:
        return param_specs(self.cfg)

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
        return shard_act(embed(tokens, self.embed), "batch", "seq", None)

    def _unembed_w(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _logits_last(self, h_last):
        """h_last: (B, d) -> (B, V) float32: float32 sums of the working
        dtype's products, as the reference's preferred_element_type."""
        return h_last.float() @ gathered(self._unembed_w()).float()

    # ------------------------------------------------------------------
    # loss (train step forward)
    # ------------------------------------------------------------------
    def loss(self, batch, params=None):
        """(loss, {"ce", "aux"}): the mean next-token cross-entropy of
        `batch` ("tokens", "labels" (B, S) int; the audio family's
        "frames" (B, F, d), the vlm family's "patches" (B, P, d), cast to
        the working dtype), plus 0.01 times the MoE load-balancing aux
        loss summed over the layers. The vlm family prepends the patches
        and pads the labels with -100 (ignored) over them. Reads the
        weights of `params` (a stacked tree, see the module docstring)
        if given, else a copy of the module's own in that layout (which
        no gradient reaches)."""
        with self._ctx():
            return self._loss(batch, params)

    def _loss(self, batch, params):
        cfg = self.cfg
        W = _Weights(cfg, param_tree(self) if params is None else params)
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        dt = W.embed.dtype
        dev = W.embed.device
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        h = shard_act(embed(tokens, W.embed), "batch", "seq", None)
        if cfg.family == "audio":
            e = batch["frames"].to(dt)
            e = e + sinusoidal_positions(e.shape[1], cfg.d_model,
                                         dev).to(dt)[None]
            enc = _remat(lambda bp, x: tfm.enc_block_apply(bp, x, cfg),
                         cfg.remat)
            for bp in W.enc:
                e = enc(bp, e)
            enc_out = norm(e, W.enc_norm, cfg)
            S = tokens.shape[1]
            h = h + sinusoidal_positions(S, cfg.d_model, dev).to(h.dtype)[None]
            positions = torch.arange(S, device=dev).expand(B, S)
            dec = _remat(lambda bp, x: tfm.xdec_block_apply(
                bp, x, enc_out, positions, cfg)[0], cfg.remat)
            for bp in W.dec:
                h = dec(bp, h)
        else:
            if cfg.family == "vlm":
                patches = batch["patches"].to(dt)
                h = torch.cat([patches, h], dim=1)
                pad = torch.full((B, patches.shape[1]), -100,
                                 dtype=labels.dtype, device=labels.device)
                labels = torch.cat([pad, labels], dim=1)
            S = h.shape[1]
            positions = torch.arange(S, device=dev).expand(B, S)
            h, aux = self._backbone_train(W, h, positions, aux)
        h = norm(h, W.final_norm, cfg)
        unembed = W.embed.T if cfg.tie_embeddings else W.unembed
        ce = chunked_softmax_xent(h, unembed, labels)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _backbone_train(self, W, h, positions, aux):
        cfg = self.cfg
        remat = functools.partial(_remat, mode=cfg.remat)
        if cfg.family == "moe":
            body = remat(lambda bp, x: tfm.moe_block_apply(bp, x, positions,
                                                           cfg))
            for bp in W.blocks:
                h, a = body(bp, h)
                aux = aux + a
        elif cfg.family == "hybrid":
            inner = remat(lambda mp, x: ssm.apply(mp, x, cfg) + x)
            for layer, mp in enumerate(W.mamba):
                h = inner(mp, h)
                if (layer + 1) % cfg.attn_every == 0:
                    h = tfm.dense_block_apply(W.shared_attn, h, positions,
                                              cfg)
        elif cfg.family == "ssm":
            inner = remat(lambda mp, x: xlstm.m_apply(mp, x, cfg) + x)
            for mls, g in self._xlstm_groups():
                for i in mls:
                    h = inner(W.mlstm[i], h)
                h = h + xlstm.s_apply(W.slstm[g], h, cfg)
        else:
            body = remat(lambda bp, x: tfm.dense_block_apply(bp, x,
                                                             positions, cfg))
            for bp in W.blocks:
                h = body(bp, h)
        return h, aux

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

    def cache_specs(self) -> dict:
        """The logical-axis tree of `init_cache`'s dict (the reference's)."""
        fam = self.cfg.family
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        sc = ("layers", "batch", "kv_seq", "kv_heads")
        if fam in KV_FAMILIES:
            if self._int8_kv():
                return {"k": kv, "v": kv, "ksc": sc, "vsc": sc}
            return {"k": kv, "v": kv}
        if fam == "audio":
            return {"k": kv, "v": kv, "xk": kv, "xv": kv}
        if fam == "hybrid":
            return {"conv": ("layers", "batch", None, "conv_dim"),
                    "ssm": ("layers", "batch", "ssm_heads", None, None),
                    "k": kv, "v": kv}
        return {"mconv": ("layers", "batch", None, "inner"),
                "mC": ("layers", "batch", "heads", None, None),
                "mN": ("layers", "batch", "heads", None),
                "mM": ("layers", "batch", "heads"),
                "sh": ("layers", "batch", "embed"),
                "sc": ("layers", "batch", "embed"),
                "sn": ("layers", "batch", "embed"),
                "sm": ("layers", "batch", "embed")}

    def init_cache(self, B, W, device=None):
        """The zeroed cache dict of B slots and W rows, on the model's
        device or `device` ("meta": shapes only)."""
        cfg = self.cfg
        dt = dtype_of(cfg)
        K, hd, L = cfg.n_kv_heads, cfg.hd(), cfg.n_layers
        dev = self.device if device is None else device
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=dev)
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
                                            device=dev)
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
        with self._ctx():
            return self._prefill(batch, W)

    def _prefill(self, batch, W=None):
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
            if W_eff == S:
                return torch.stack(rows)
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
                for g in range(xlstm_depths(self.cfg)[1])]

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
        with self._ctx():
            return self._decode_step(cache, token, pos)

    def _decode_step(self, cache, token, pos):
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
