"""GQA attention: flash prefill path and KV-cache decode path, with the
sliding-window ring cache and the int8 cache (port of
`repro.models.attention`).

Prefill attention (`attend_train` and `cross_attend_train` ->
`flash_attention`) calls the flash-attention kernel: a CUDA tensor launches
`csrc/flash_attention.cu` through `kernels.flash_attention.ops` (or
raises), a CPU tensor runs the blocked pure-torch flash attention of the
reference (`kernels.flash_attention.kernel.flash_attention_plain`); a
sliding window goes into the kernel's mask. Decode writes the new K/V
row (and, for an int8 cache, its scales) into the cache in place, then
attends one new token against the cache: a CUDA cache launches the
decode-attention kernel `csrc/decode_attention.cu` through
`kernels.decode_attention.kernel.decode_attention` (or raises), which
reads the cache in place and only each slot's filled rows; a CPU cache,
and a DTensor cache under a mesh, run `decode_attention_plain`, the
reference's plain masked einsums (the reference has no kernel there).
Under a sliding window the cache is a
ring of `window` rows indexed by pos % window (`seed_ring_cache` lays out
a prefill's rows so); an int8 cache holds per-token, per-head symmetric
int8 values with bf16 scales (`quantize_kv`), folded into the scores and
the weights as the reference does.

The audio family (whisper) attends without rotation: its encoder
bidirectionally (`attend_train(..., use_rope=False, causal=False)`), its
decoder causally, and its cross-attention (`cross_attend_train`) against
the encoder's K/V (`cross_kv`) with `causal=False`, so both launch the
flash kernel in non-causal mode on CUDA tensors. Cross-attention during
decode (`cross_decode`) is plain torch, as in the reference. As there,
the cross-attention projections take no bias.

Under a mesh (`Model(cfg, mesh=...)`, DTensor activations) `_qkv` and
`attend_train` annotate q, k, v and the output with the reference's
logical axes (`shard_act`), the flash entry runs per rank through
`local_map` (`_mesh_flash`: tensor-parallel over the heads, or the
reference's sequence-parallel flash where `_want_seqpar` says so), and
decode writes its cache rows through each rank's local slice
(`write_rows`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.decode_attention.kernel import decode_attention, \
    decode_attention_plain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import axis_sizes, current_mesh, \
    dense_init, dtype_of, gathered, is_dtensor, param, reshaped, rope, \
    shard_act, shard_act_as, softmax_last


class Attention(nn.Module):
    """Parameters of one attention layer: wq (d, H, hd), wk/wv (d, K, hd),
    wo (H, hd, d), and with `cfg.qkv_bias` bq (H, hd), bk/bv (K, hd)."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
        dt = dtype_of(cfg)
        self.wq = param(dense_init(gen, (d, H, hd), dt, device=device))
        self.wk = param(dense_init(gen, (d, K, hd), dt, device=device))
        self.wv = param(dense_init(gen, (d, K, hd), dt, device=device))
        self.wo = param(dense_init(gen, (H, hd, d), dt,
                                   scale=1.0 / math.sqrt(H * hd),
                                   device=device))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((H, hd), dtype=dt, device=device))
            self.bk = param(torch.zeros((K, hd), dtype=dt, device=device))
            self.bv = param(torch.zeros((K, hd), dtype=dt, device=device))


def init(gen, cfg, device="cuda") -> Attention:
    return Attention(cfg, gen, device=device)


def specs(cfg):
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    return p


def _heads_in(x, w, heads="heads"):
    """einsum("bsd,dhk->bshk", x, w), contiguous. A DTensor product is
    first laid out as the rules lay out its `heads` axis, so that the
    flat (H * hd) axis splits into whole heads."""
    B, S, d = x.shape
    y = x @ reshaped(gathered(w), d, -1)
    if is_dtensor(y):
        y = shard_act_as(y, (B, S, w.shape[1], w.shape[2]),
                         "batch", "seq", heads, "head_dim")
    return y.view(B, S, w.shape[1], w.shape[2])


def _heads_out(o, w):
    """einsum("bshk,hkd->bsd", o, w)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ reshaped(gathered(w), -1, w.shape[-1])


def _project(p, x):
    q = _heads_in(x, p.wq)
    k, v = _heads_in(x, p.wk, "kv_heads"), _heads_in(x, p.wv, "kv_heads")
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _qkv(p, x, cfg, positions, use_rope=True):
    q, k, v = _project(p, x)
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard_act(q, "batch", "seq", "heads", "head_dim")
    k = shard_act(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard_act(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, chunk_q=512, chunk_kv=1024):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H = K * G. Returns (B, Sq,
    H, hd). Float32 online softmax over KV chunks, GQA via head groups."""
    return fa_ops.flash_attention(q, k, v, q_offset, bq=chunk_q,
                                  bkv=chunk_kv, causal=causal, window=window,
                                  kv_len=kv_len)


def _shard_coord(mesh, placements, dim) -> tuple:
    """(index, count) of this rank's slice of tensor dimension `dim` under
    `placements`: the mesh axes that shard it, major to minor."""
    from repro_torch.launch.mesh import coordinate
    names = mesh.mesh_dim_names
    axes = [names[i] for i, pl in enumerate(placements)
            if pl.is_shard(dim)]
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return coordinate(mesh, axes), n


def _mesh_flash(q, k, v, mesh, *, causal, window, seqpar):
    """Flash attention of DTensors, through `local_map`: each rank runs
    the flash entry (the kernel on the card) on its own slices. TP (the
    default): q as its heads are sharded, k and v as theirs; a rank
    attends its q heads to the kv heads of their groups, which it holds
    (raises if a shard splits a group unevenly). Sequence-parallel
    (`seqpar`, the reference's `_seqpar_flash`): q's sequence sharded
    over 'model', k and v replicated over it, q_offset from the rank on
    'model'; zero collectives inside attention. q has Sq rows and k, v
    Skv (cross-attention: the prompt against the encoder's frames); a
    split of q's rows offsets its queries by Sq // ranks each, and the
    keys are never split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, Sq, H, _ = q.shape
    K = k.shape[2]
    G = H // K
    if seqpar:
        data = [a for a in mesh.mesh_dim_names if a != "model"]
        n_data = 1
        for a in data:
            n_data *= axis_sizes(mesh)[a]
        bsh = Shard(0) if data and B % n_data == 0 else Replicate()
        qp = tuple(Shard(1) if a == "model" else bsh
                   for a in mesh.mesh_dim_names)
        kp = tuple(Replicate() if a == "model" else bsh
                   for a in mesh.mesh_dim_names)
    else:
        qp, kp = tuple(q.placements), tuple(k.placements)
    hq, nq = _shard_coord(mesh, qp, 2)
    hk, nk = _shard_coord(mesh, kp, 2)
    sq, ns = _shard_coord(mesh, qp, 1)
    H_l, K_l = H // nq, K // nk
    h0, k0 = hq * H_l, hk * K_l
    ka, kb = h0 // G, (h0 + H_l - 1) // G + 1   # the kv heads q_l needs
    if (H_l % G if H_l >= G else G % H_l) \
            or not k0 <= ka < kb <= k0 + K_l:
        raise ValueError(f"a shard of {H_l} of {H} query heads (from "
                         f"{h0}) does not hold whole groups of {G} over "
                         f"kv heads {k0}..{k0 + K_l - 1}")
    off = sq * (Sq // ns)

    def fn(ql, kl, vl):
        if (ka - k0, kb - k0) != (0, K_l):
            kl = kl[:, :, ka - k0:kb - k0].contiguous()
            vl = vl[:, :, ka - k0:kb - k0].contiguous()
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               q_offset=off)

    o = local_map(fn, out_placements=(qp,), in_placements=(qp, kp, kp),
                  device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    # back to q's layout (a sequence-parallel o gathered over 'model')
    return shard_act(o, "batch", "seq", "heads", "head_dim")


def _want_seqpar(cfg, q, k):
    """The mesh, when attention should be sequence-parallel: under a mesh
    with a 'model' axis and `cfg.attn_seqpar`, a head count that does not
    divide that axis, and at least 128 queries a rank."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names \
            or not cfg.attn_seqpar:
        return None
    m = axis_sizes(mesh)["model"]
    H, S = q.shape[2], q.shape[1]
    if H % m == 0:          # heads shard fine; TP attention is better
        return None
    if S % m != 0 or S // m < 128:
        return None
    return mesh


def attend_train(p, x, positions, cfg, *, use_rope=True, causal=True):
    """Full training/prefill attention, causal unless `causal` is False;
    no rotation with `use_rope=False` or `positions=None`. Returns (out
    (B, S, d), k, v). Under a mesh the flash entry runs per rank
    (`_mesh_flash`), sequence-parallel where `_want_seqpar` says so."""
    q, k, v = _qkv(p, x, cfg, positions, use_rope)
    if is_dtensor(q):
        o = _mesh_flash(q, k, v, q.device_mesh, causal=causal,
                        window=cfg.sliding_window,
                        seqpar=_want_seqpar(cfg, q, k) is not None)
    else:
        o = flash_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window)
    return shard_act(_heads_out(o, p.wo), "batch", "seq", "embed"), k, v


def cross_kv(p, enc_out):
    """The encoder output's K and V for cross-attention: (B, F, K, hd)
    each, no bias (as the reference)."""
    return _heads_in(enc_out, p.wk), _heads_in(enc_out, p.wv)


def cross_attend_train(p, x, enc_kv, cfg):
    """Decoder cross-attention against precomputed encoder K/V, through
    the flash kernel in non-causal mode (per rank under a mesh,
    tensor-parallel over the heads, as the reference's plain flash call
    is laid out). Returns (B, S, d)."""
    k, v = enc_kv
    q = _heads_in(x, p.wq)
    if is_dtensor(q):
        o = _mesh_flash(q, k, v, q.device_mesh, causal=False, window=0,
                        seqpar=False)
    else:
        o = flash_attention(q, k, v, causal=False)
    return shard_act(_heads_out(o, p.wo), "batch", "seq", "embed")


def cross_decode(p, x, cross_k, cross_v):
    """Cross-attention of one token (B, 1, d) against the static encoder
    cache (B, F, K, hd), in plain torch: float32 scores from the working
    dtype's operands, softmax, weights rounded to V's dtype."""
    B = x.shape[0]
    q = _heads_in(x, p.wq)
    H, hd = q.shape[2], q.shape[3]
    K = cross_k.shape[2]
    # one token's q whole over its heads, as `decode` lays it out
    q = shard_act(q, "batch", "seq", None, "head_dim")
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cross_k.float()) / math.sqrt(hd)
    w = softmax_last(s)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(cross_v.dtype), cross_v)
    return _heads_out(o.reshape(B, 1, H, hd), p.wo)


def quantize_kv(k, axis=-1):
    """Symmetric int8 per-token-per-head quantization. k: (..., hd) ->
    (int8 like k, scale (...,) bf16). Rounds half to even, as jnp.round;
    divides by tensors (a CUDA division by a Python number multiplies by
    its reciprocal, which can move a scale by an ulp)."""
    kf = k.float()
    s = kf.abs().amax(dim=axis) / kf.new_tensor(127.0)
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(kf / s.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def seed_ring_cache(k, v, window):
    """Convert full prefill K/V (..., S, K, hd) into a ring cache of
    `window` rows (..., W, K, hd) laid out so that slot = pos % W, ready
    for decode at pos = S: the last W positions when S > W."""
    S = k.shape[-3]
    W = window
    if S <= W:
        ck = k.new_zeros(k.shape[:-3] + (W,) + k.shape[-2:])
        cv = v.new_zeros(v.shape[:-3] + (W,) + v.shape[-2:])
        ck[..., :S, :, :] = k
        cv[..., :S, :, :] = v
        return ck, cv
    # position S - W + j goes to slot (S - W + j) % W: the tail rolled by
    # S % W, as two slices (a DTensor has them, and no index write or roll)
    def ring(t):
        tail = t[..., S - W:, :, :]
        cut = W - S % W
        return torch.cat([tail[..., cut:, :, :], tail[..., :cut, :, :]],
                         dim=-3)
    return ring(k), ring(v)


def write_rows(cache, rows, slot, bidx):
    """cache[b, slot[b]] = rows[b] for every b, in place; cache (B, W,
    ...), rows (B, ...), bidx = arange(B) (one for a step's writes). A
    DTensor cache (its rows possibly sharded, the decode rules' kv_seq) is
    written through its local slice: each rank writes the rows whose slot
    falls in its part of W and rewrites the value it holds elsewhere."""
    if not is_dtensor(cache):
        cache[bidx, slot] = rows
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    cp = tuple(cache.placements)
    # rows and slot laid out as the cache's batch and trailing dimensions
    rp = tuple(Shard(pl.dim - (pl.dim > 1)) if pl.is_shard()
               and pl.dim != 1 else Replicate() for pl in cp)
    sp = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in cp)
    if not is_dtensor(slot):
        slot = DTensor.from_local(slot, mesh, [Replicate()] * len(cp),
                                  run_check=False)
    if not is_dtensor(rows):
        rows = DTensor.from_local(rows, mesh, [Replicate()] * len(cp),
                                  run_check=False)
    c = cache.to_local()
    r = rows.redistribute(mesh, rp).to_local()
    sl = slot.redistribute(mesh, sp).to_local()
    w, _ = _shard_coord(mesh, cp, 1)
    W_l = c.shape[1]
    idx = sl - w * W_l
    inside = (idx >= 0) & (idx < W_l)
    idx = idx.clamp(0, W_l - 1)
    bidx = torch.arange(c.shape[0], device=c.device)    # the local rows
    keep = inside.view((-1,) + (1,) * (r.dim() - 1))
    c[bidx, idx] = torch.where(keep, r.to(c.dtype), c[bidx, idx])


def decode(p, x, cache_k, cache_v, pos, cfg, *, use_rope=True, ring=False,
           scales=None):
    """x: (B, 1, d); cache_k/v: (B, W, K, hd); pos: (B,) int32 current
    index. Writes the new K/V rows at slot pos % W (`ring`) or
    min(pos, W - 1) into the caches in place and returns (out (B, 1, d),
    cache_k, cache_v[, (ks, vs)]). `scales`: (ks, vs), each (B, W, K)
    bf16, for int8 caches; the new rows are quantized, and the scales
    multiply the float32 scores and the softmax weights. No rotation with
    `use_rope=False` (the audio decoder)."""
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = _project(p, x)
    if use_rope:
        at = pos[:, None]
        q = rope(q, at, cfg.rope_theta)
        k = rope(k, at, cfg.rope_theta)
    pos = pos.long()
    slot = pos % W if ring else torch.clamp_max(pos, W - 1)
    bidx = torch.arange(B, device=x.device)
    if scales is not None:
        ks, vs = scales
        kq, ksc = quantize_kv(k[:, 0])
        vq, vsc = quantize_kv(v[:, 0])
        write_rows(cache_k, kq, slot, bidx)
        write_rows(cache_v, vq, slot, bidx)
        write_rows(ks, ksc, slot, bidx)
        write_rows(vs, vsc, slot, bidx)
    else:
        write_rows(cache_k, k[:, 0].to(cache_k.dtype), slot, bidx)
        write_rows(cache_v, v[:, 0].to(cache_v.dtype), slot, bidx)

    # one token's q whole over its heads, so that (H) splits into (K, G)
    q = shard_act(q, "batch", "seq", None, "head_dim")
    if is_dtensor(cache_k) or not cache_k.is_cuda:
        o = decode_attention_plain(q, cache_k, cache_v, pos, ring=ring,
                                   scales=scales)
    else:
        o = decode_attention(q, cache_k, cache_v, pos, scales=scales)
    o = _heads_out(o, p.wo)
    if scales is not None:
        return o, cache_k, cache_v, (ks, vs)
    return o, cache_k, cache_v
