"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM
(scalar memory, sequential scan) (port of `repro.models.xlstm`).

mLSTM follows the stabilized chunkwise form: per-position stabilizer
m_i = max(b_i + m_prev, max_{j<=i}(b_i - b_j + i~_j)) where b is the
intra-chunk cumulative log-forget and i~ the log input gate; every exp()
is then <= 1. The recurrent state is (C (B, H, Dq, Dv), n (B, H, Dq),
m (B, H)), float32 whatever the working dtype, carried across chunks of
`CHUNK` positions by a Python loop (the reference's `lax.scan`) and
across decode steps one token at a time. Masked entries of a chunk's
log-weights are -inf, so their weights are exact zeros; the stabilizer
is kept at or above -1e30 for rows with no finite weight.

`m_apply` reads `CHUNK` from this module at call time, and a prompt
longer than `CHUNK` must be a multiple of it (the reference's
`assert S % Q == 0`): padding on the right would run the pad through the
recurrence and corrupt the state a decode continues from.

The sLSTM scans S steps one at a time (it is inherently serial: each
step's gates read the previous step's h), about 20 torch operations a
step on the host.

Under a mesh the weights are DTensors placed by the specs, each gathered
over the data axes at its use (`Gathered`). The mLSTM's projections run
on DTensors, its activations laid out by heads (`_by_heads`: the inner
axis split over 'model' in whole heads where they divide it, else
replicated: xlstm-1.3b's 4 heads over 16), and its chunk scan, or one
decode step's cell, runs per rank through `local_map` (`_per_rank`).
The sLSTM's recurrent weights `r` are per head, while `w`'s last axis
is split over 'model', so one head's channels span several ranks and a
DTensor step would make collectives at every one of its S steps. So the
input contribution `wx` is computed split over 'model' (one product a
gate), gathered over 'model' once, and the whole scan runs on each
rank's local tensors through one `local_map` call, the batch over the
data axes (`_mesh_scan`): one collective a call. These layouts are the
port's choice; the reference's XLA layout of its `lax.scan` cannot be
read on JAX 0.9.

Block layout (xLSTM paper, arXiv:2405.04517): mLSTM is a pre-LN residual
block with 2x up-projection, causal conv4 + silu for q/k, per-head gates,
headwise GroupNorm, learnable skip and silu(z) gating. sLSTM is a pre-LN
residual block with a 4-gate recurrent cell (block-diagonal recurrent
matrix over heads) followed by a GeGLU FFN of factor 4/3 (tanh GELU, the
reference's `jax.nn.gelu` default). The gate weights and biases (`w_if`,
`b_if`, the sLSTM's `b`) are float32 parameters, as in the reference.

Plain torch: the reference runs both recurrences as `lax.scan` with no
Pallas kernel, so the port has no kernel here either. Used by xlstm-1.3b
(6 groups of 7 mLSTM layers and 1 sLSTM layer, models/model.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Gathered, axis_sizes, dense_init, \
    dtype_of, gathered, is_dtensor, param, reshaped, rms_norm, shard_act, \
    shard_act_as

CHUNK = 256


def _log_sigmoid(x):
    """jax.nn.log_sigmoid: -softplus(-x), softplus as logaddexp(x, 0)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def m_dims(cfg):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    hd_v = inner // nh
    hd_qk = cfg.hd()
    return inner, nh, hd_qk, hd_v


class MLSTM(nn.Module):
    """w_up, w_z (d, inner), conv_w (4, inner), conv_b (inner,), wq, wk
    (inner, H, Dq), w_if (inner, H, 2) and b_if (H, 2) float32, gn
    (H, Dv), skip (inner,), w_down (inner, d)."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d = cfg.d_model
        inner, nh, hq, hv = m_dims(cfg)
        dt = dtype_of(cfg)
        self.w_up = param(dense_init(gen, (d, inner), dt, device=device))
        self.w_z = param(dense_init(gen, (d, inner), dt, device=device))
        self.conv_w = param(dense_init(gen, (4, inner), dt, scale=0.5,
                                       device=device))
        self.conv_b = param(torch.zeros((inner,), dtype=dt, device=device))
        self.wq = param(dense_init(gen, (inner, nh, hq), dt, device=device))
        self.wk = param(dense_init(gen, (inner, nh, hq), dt, device=device))
        self.w_if = param(dense_init(gen, (inner, nh, 2), torch.float32,
                                     scale=0.01, device=device))
        b_if = torch.zeros((nh, 2), dtype=torch.float32, device=device)
        if b_if.device.type != "meta":
            b_if[:, 1] = torch.linspace(3.0, 6.0, nh, device=device)
        self.b_if = param(b_if)
        self.gn = param(torch.ones((nh, hv), dtype=dt, device=device))
        self.skip = param(torch.zeros((inner,), dtype=dt, device=device))
        self.w_down = param(dense_init(gen, (inner, d), dt, device=device))


def m_specs(cfg):
    return {
        "w_up": ("embed", "inner"),
        "w_z": ("embed", "inner"),
        "conv_w": (None, "inner"),
        "conv_b": ("inner",),
        "wq": ("inner", "heads", "head_dim"),
        "wk": ("inner", "heads", "head_dim"),
        "w_if": ("inner", "heads", None),
        "b_if": ("heads", None),
        "gn": ("heads", None),
        "skip": ("inner",),
        "w_down": ("inner", "embed"),
    }


def m_init(gen, cfg, device="cuda") -> MLSTM:
    return MLSTM(cfg, gen, device=device)


def _conv4(u, w, b, hist=None):
    """Depthwise causal conv over k = w.shape[0] taps, a sum of shifted
    products in u's dtype. u: (B, S, C); hist: (B, k-1, C) or None."""
    k = w.shape[0]
    pad = (u.new_zeros((u.shape[0], k - 1, u.shape[2])) if hist is None
           else hist.to(u.dtype))
    x = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = x[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + x[:, i:i + S] * w[i]
    return out + b


def _headnorm(h, gn, eps):
    """Per-head groupnorm on (..., H, Dv), returned in float32."""
    hf = h.float()
    mu = torch.mean(hf, dim=-1, keepdim=True)
    var = torch.var(hf, dim=-1, keepdim=True, correction=0)
    return (hf - mu) * torch.rsqrt(var + eps) * gn.float()


def _gates(p, c):
    """(log input gate, log forget gate), float32, from c (..., inner)."""
    gif = torch.einsum("...e,ehg->...hg", c.float(), p.w_if) + p.b_if
    # laid out, and its gradient too, as the heads are
    gif = shard_act(gif, *(("batch", "seq")[:gif.dim() - 2]
                           + ("heads", None)))
    return gif[..., 0], _log_sigmoid(gif[..., 1])


def _m_out(p, h, c, z, x_dtype, cfg):
    """headnorm(h) + skip * c, gated by silu(z), in float32; cast to the
    working dtype and projected down."""
    inner = p.skip.shape[0]
    h = reshaped(_headnorm(h, p.gn, cfg.norm_eps), *h.shape[:-2], inner)
    h = (h + p.skip.float() * c.float()) * F.silu(z.float())
    return h.to(x_dtype) @ p.w_down


def _by_heads(t, nh):
    """t (B, S, inner) laid out, and its gradient too, as the rules lay
    out its (H, Dv) split: inner split over 'model' in whole heads when
    the heads divide it, else replicated over 'model' (xlstm-1.3b's 4
    heads over 16), so that every elementwise step of the block and its
    view as heads stay local; the identity on a plain tensor."""
    if not is_dtensor(t):
        return t
    return shard_act_as(t, t.shape[:-1] + (nh, t.shape[-1] // nh),
                        "batch", "seq", "heads", None)


def _m_core(q, k, v, ig, lf, state, Q):
    """The chunked mLSTM over q, k (B, S, H, Dq), v (B, S, H, Dv) and the
    log gates (B, S, H), from `state` (C, n, m) or zeros. Returns (h
    (B, S, H, Dv), the state after the last chunk)."""
    B, S, nh, hq = q.shape
    hv = v.shape[-1]
    nc = S // Q
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    if state is None:
        C = torch.zeros((B, nh, hq, hv), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((B, nh, hq), dtype=torch.float32, device=q.device)
        m = torch.full((B, nh), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    hs = []
    for ci in range(nc):
        sl = slice(ci * Q, (ci + 1) * Q)
        qq, kk, vv, ii, ff = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], \
            lf[:, sl]
        b = torch.cumsum(ff, dim=1)              # (B, Q, H) cum log-forget
        # log weights of intra contributions: g[i,j] = b_i - b_j + i~_j
        g = b[:, :, None, :] - b[:, None, :, :] + ii[:, None, :, :]
        g = torch.where(causal, g, -math.inf)
        m_intra = g.amax(dim=2)                  # (B, Q, H)
        m_inter = b + m[:, None, :]
        mi = torch.clamp_min(torch.maximum(m_intra, m_inter), -1e30)
        w = torch.exp(g - mi[:, :, None, :])     # (B, Q, Q, H), <= 1
        s = torch.einsum("bqhk,bshk->bqsh", qq, kk)
        h_intra = torch.einsum("bqsh,bshv->bqhv", s * w, vv)
        dec = torch.exp(m_inter - mi)            # (B, Q, H)
        h_inter = torch.einsum("bqhk,bhkv->bqhv", qq, C) * dec[..., None]
        n_i = torch.einsum("bqsh,bshk->bqhk", w, kk) \
            + dec[..., None] * n[:, None]
        qn = torch.abs(torch.einsum("bqhk,bqhk->bqh", qq, n_i))
        hs.append((h_intra + h_inter)
                  / torch.maximum(qn, torch.exp(-mi))[..., None])
        # the state at the chunk's end
        bQ = b[:, -1]                            # (B, H)
        g_st = bQ[:, None, :] - b + ii           # (B, Q, H)
        m_new = torch.maximum(g_st.amax(dim=1), bQ + m)
        w_st = torch.exp(g_st - m_new[:, None, :])
        keep = torch.exp(bQ + m - m_new)
        C = C * keep[..., None, None] + torch.einsum(
            "bqhk,bqhv->bhkv", w_st[..., None] * kk, vv)
        n = n * keep[..., None] + torch.einsum("bqh,bqhk->bhk", w_st, kk)
        m = m_new
    return torch.cat(hs, dim=1), (C, n, m)


def _per_rank(q, k, v, ig, lf, state, Q=None):
    """The mLSTM cell of DTensors per rank through `local_map`: the
    chunked `_m_core` (with a chunk length Q) or one token's `_m_step`.
    The batch over the data axes and the heads over 'model', each where
    it divides them (xlstm-1.3b's 4 heads do not divide a 'model' axis of
    16, so every rank of a data shard runs all of them). Zero collectives
    inside."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    n_data = math.prod(v_ for a, v_ in sizes.items() if a != "model")
    split = q.shape[0] % n_data == 0
    by_head = "model" in names and q.shape[-2] % sizes["model"] == 0

    def pl(head_dim):
        return tuple((Shard(0) if split else Replicate()) if a != "model"
                     else Shard(head_dim) if by_head else Replicate()
                     for a in names)
    qkv, gates, st = pl(q.dim() - 2), pl(ig.dim() - 1), (pl(1),) * 3
    fresh = state is None

    def fn(ql, kl, vl, il, fl, *s_):
        s_ = None if fresh else s_
        h, s_ = (_m_core(ql, kl, vl, il, fl, s_, Q) if Q is not None
                 else _m_step(ql, kl, vl, il, fl, s_))
        return (h,) + tuple(s_)

    h, C, n, m = local_map(
        fn, out_placements=(qkv,) + st,
        in_placements=(qkv,) * 3 + (gates,) * 2 + (() if fresh else st),
        device_mesh=mesh, redistribute_inputs=True)(
            q, k, v, ig, lf, *(() if fresh else state))
    return h, (C, n, m)


def m_apply(p, x, cfg, state=None, return_state=False):
    """x: (B, S, d) -> (B, S, d), chunkwise-parallel stabilized mLSTM.
    With `return_state` also returns (conv history (B, 3, inner), (C, n,
    m)) to continue from in decode."""
    B, S, d = x.shape
    p = Gathered(p)
    inner, nh, hq, hv = m_dims(cfg)
    Q = min(CHUNK, S)
    assert S % Q == 0, (S, Q)
    scale = 1.0 / math.sqrt(hq)

    u = _by_heads(x @ p.w_up, nh)
    z = _by_heads(x @ p.w_z, nh)
    c = _by_heads(F.silu(_conv4(u, p.conv_w, p.conv_b)), nh)
    # the reference multiplies its working-dtype product by a numpy
    # float64 scale, which JAX promotes to float32: the product is rounded
    # to the working dtype, then scaled in float32, as here
    q = (c @ p.wq.reshape(inner, -1)).view(B, S, nh, hq).float() * scale
    k = (c @ p.wk.reshape(inner, -1)).view(B, S, nh, hq).float()
    v = u.reshape(B, S, nh, hv).float()
    ig, lf = _gates(p, c)                                   # (B, S, H)
    if is_dtensor(q):
        h, (C, n, m) = _per_rank(q, k, v, ig, lf, state, Q)
    else:
        h, (C, n, m) = _m_core(q, k, v, ig, lf, state, Q)
    out = shard_act(_m_out(p, h, c, z, x.dtype, cfg), "batch", "seq",
                    "embed")
    if return_state:
        hist = u[:, max(S - 3, 0):]
        pad = u.new_zeros((B, max(3 - S, 0), inner))
        return out, (torch.cat([pad, hist], dim=1), (C, n, m))
    return out


def m_decode(p, x, conv_hist, state, cfg):
    """One-token mLSTM step. x: (B, 1, d); conv_hist: (B, 3, inner);
    state: (C, n, m). Returns (out (B, 1, d), conv_hist, state)."""
    B = x.shape[0]
    p = Gathered(p)
    inner, nh, hq, hv = m_dims(cfg)
    scale = 1.0 / math.sqrt(hq)

    u = _by_heads(x @ p.w_up, nh)
    z = _by_heads(x @ p.w_z, nh)
    hist = torch.cat([conv_hist.to(u.dtype), u], dim=1)     # (B, 4, inner)
    conv_hist = hist[:, 1:]
    c = _by_heads(F.silu(torch.einsum("bke,ke->be", hist, p.conv_w)
                         + p.conv_b)[:, None], nh)[:, 0]
    q = (c @ p.wq.reshape(inner, -1)).view(B, nh, hq).float() * scale
    k = (c @ p.wk.reshape(inner, -1)).view(B, nh, hq).float()
    v = u[:, 0].reshape(B, nh, hv).float()
    ii, ff = _gates(p, c)                                   # (B, H)

    step = _per_rank if is_dtensor(q) else _m_step
    h, state = step(q, k, v, ii, ff, state)
    out = shard_act(_m_out(p, h, c, z[:, 0], x.dtype, cfg)[:, None],
                    "batch", "seq", "embed")
    return out, conv_hist, state


def _m_step(q, k, v, ii, ff, state):
    """One token of the mLSTM cell: q, k (B, H, Dq), v (B, H, Dv), the
    log gates (B, H), state (C, n, m). Returns (h (B, H, Dv), state)."""
    C, n, m = state
    m_new = torch.maximum(ff + m, ii)
    fd = torch.exp(ff + m - m_new)[..., None]
    iw = torch.exp(ii - m_new)[..., None]
    C = C * fd[..., None] + (iw * k)[..., None] * v[:, :, None, :]
    n = n * fd + iw * k
    h_num = torch.einsum("bhk,bhkv->bhv", q, C)
    qn = torch.abs(torch.einsum("bhk,bhk->bh", q, n))
    h = h_num / torch.maximum(qn, torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def s_dims(cfg):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    ff = int(round(cfg.d_model * 4 / 3 / 64)) * 64
    return nh, dh, ff


class SLSTM(nn.Module):
    """w (d, 4, d) input gates z, i, f, o; r (H, dh, 4, dh) block-diagonal
    recurrent weights; b (4, d) float32; gn (d,); w_ff1 (d, 2 ff), w_ff2
    (ff, d)."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d = cfg.d_model
        nh, dh, ff = s_dims(cfg)
        dt = dtype_of(cfg)
        self.w = param(dense_init(gen, (d, 4, d), dt, device=device))
        self.r = param(dense_init(gen, (nh, dh, 4, dh), dt, scale=0.01,
                                  device=device))
        b = torch.zeros((4, d), dtype=torch.float32, device=device)
        if b.device.type != "meta":
            b[2] = torch.linspace(3.0, 6.0, dh, device=device).repeat(nh)
        self.b = param(b)
        self.gn = param(torch.ones((d,), dtype=dt, device=device))
        self.w_ff1 = param(dense_init(gen, (d, 2 * ff), dt, device=device))
        self.w_ff2 = param(dense_init(gen, (ff, d), dt, device=device))


def s_specs(cfg):
    return {
        "w": ("embed", None, "inner"),
        "r": ("heads", None, None, None),
        "b": (None, "inner"),
        "gn": ("embed",),
        "w_ff1": ("embed", "mlp"),
        "w_ff2": ("mlp", "embed"),
    }


def s_init(gen, cfg, device="cuda") -> SLSTM:
    return SLSTM(cfg, gen, device=device)


def _s_cell(r32, b, wx_t, state, cfg):
    """One sLSTM timestep. r32, b: the cell's recurrent weights (in
    float32) and bias; wx_t: (B, 4, d) precomputed input contribution;
    state (h, c, n, m), each (B, d) float32."""
    nh, dh, _ = s_dims(cfg)
    h, c, n, m = state
    B, d = h.shape
    rh = torch.einsum("bhk,hkgl->bhgl", h.reshape(B, nh, dh), r32)
    g = wx_t.float().reshape(B, 4, nh, dh) + rh.transpose(1, 2)
    g = g.reshape(B, 4, d) + b
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]                        # log-space input gate
    ft = _log_sigmoid(g[:, 2])          # log-space forget gate
    ot = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c_new = f_ * c + i_ * zt
    n_new = f_ * n + i_
    h_new = ot * c_new / torch.clamp_min(torch.abs(n_new), 1.0)
    return h_new, c_new, n_new, m_new


def _zero_state(B, d, device):
    zero = torch.zeros((B, d), dtype=torch.float32, device=device)
    return (zero, zero, zero,
            torch.full((B, d), -1e30, dtype=torch.float32, device=device))


def _scan(r, b, wx, state, cfg):
    """The S steps of the cell over wx (B, S, 4, d) from `state` (zeros
    if None). Returns (h of every step (B, S, d) float32, final state)."""
    if state is None:
        state = _zero_state(wx.shape[0], wx.shape[-1], wx.device)
    r32 = r.float()
    hs = []
    for t in range(wx.shape[1]):
        state = _s_cell(r32, b, wx[:, t], state, cfg)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def _mesh_scan(p, x, state, cfg):
    """`_scan` of DTensors: wx split over 'model' (one product a gate),
    gathered over it once, then the whole scan per rank through
    `local_map`, the batch over the data axes when it divides them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    n_data = math.prod(v for a, v in sizes.items() if a != "model")
    split = x.shape[0] % n_data == 0
    bpl = tuple(Shard(0) if split and a != "model" else Replicate()
                for a in names)
    rep = (Replicate(),) * len(names)
    w_grad = tuple(Partial() if split and a != "model" else Replicate()
                   for a in names)
    w = gathered(p.w)
    wx = torch.stack([x @ w[:, g] for g in range(4)], dim=2)
    wx = wx.redistribute(mesh, bpl)
    fresh = state is None

    def fn(wx_l, r, b, *st):
        hs, st = _scan(r, b, wx_l, None if fresh else st, cfg)
        return (hs,) + tuple(st)

    n_st = 0 if fresh else 4
    out = local_map(
        fn, out_placements=(bpl,) * 5,
        in_placements=(bpl, rep, rep) + (bpl,) * n_st,
        in_grad_placements=(bpl, w_grad, w_grad) + (bpl,) * n_st,
        device_mesh=mesh, redistribute_inputs=True)(
            wx, p.r, p.b, *(() if fresh else state))
    return out[0], tuple(out[1:])


def s_apply(p, x, cfg, state=None, return_state=False):
    """x: (B, S, d) -> (B, S, d), a sequential scan over S. With
    `return_state` also returns the state (h, c, n, m) after the last
    step. Under a mesh the scan runs per rank (`_mesh_scan`)."""
    B, S, d = x.shape
    if is_dtensor(x):
        hs, state = _mesh_scan(p, x, state, cfg)
    else:
        wx = (x @ p.w.reshape(d, -1)).view(B, S, 4, d)
        hs, state = _scan(p.r, p.b, wx, state, cfg)
    h = rms_norm(hs.to(x.dtype), gathered(p.gn), cfg.norm_eps)
    a, b = (h @ gathered(p.w_ff1)).chunk(2, dim=-1)
    out = shard_act((F.gelu(a.float(), approximate="tanh").to(x.dtype) * b)
                    @ gathered(p.w_ff2), "batch", "seq", "embed")
    if return_state:
        return out, state
    return out


def s_decode(p, x, state, cfg):
    return s_apply(p, x, cfg, state=state, return_state=True)
