"""Mamba2 (SSD) block: chunkwise-parallel selective state-space layer
(port of `repro.models.ssm`).

Prefill runs the chunked dual form, chunks of `CHUNK` positions: within
a chunk the "attention-like" products, across chunks a scan of the
(B, H, P, N) state; every decay is a log-space cumulative sum with
da <= 0, so each exp() factor is at most 1 and float32 needs no max
stabilizer. The state math is float32 whatever the working dtype; the
gated output (y * silu(z)) is cast to the working dtype before the
RMS norm, as in the reference. The depthwise causal convolution is a sum
of shifted products in the working dtype (no convolution library call,
so no TF32 enters on the card).

Decode advances the state one token at a time with the last k-1
pre-activation conv inputs as history.

Under autograd the chunk's masked decay exponents are set to -inf before
exp (the reference exponentiates them and masks after, which overflows
to inf at S = 64 on reduced zamba2 and turns the whole backward into
NaN); the forward is the reference's bit for bit.

A prompt longer than `CHUNK` must be a multiple of it (the reference's
`assert S % Q == 0`): padding on the right would run the pad through the
recurrence and corrupt the state a decode continues from.

Under a mesh the input projection and the gated output run on
DTensors and the conv with the chunk scan runs per rank through
`local_map` (`_mesh_core`): the batch over the data axes, the heads over
'model' (the reference's ssm_heads), so the scan makes no collective.

Plain torch: the reference has no Pallas kernel here (its chunk scan is
XLA), so the port has none either. Used by zamba2-2.7b (54 Mamba2 layers
and one shared attention block, models/model.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Gathered, axis_sizes, dense_init, \
    dtype_of, is_dtensor, param, rms_norm, shard_act

CHUNK = 256


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


class Mamba2(nn.Module):
    """w_in (d, 2 di + 2 N + nh), conv_w (k, cdim), conv_b (cdim,), A_log,
    D, dt_bias (nh,) float32, norm (di,), w_out (di, d)."""

    def __init__(self, cfg, gen=None, device="cuda"):
        super().__init__()
        d = cfg.d_model
        di, nh, cdim = dims(cfg)
        N = cfg.ssm_state
        dt = dtype_of(cfg)
        self.w_in = param(dense_init(gen, (d, 2 * di + 2 * N + nh), dt,
                                     device=device))
        self.conv_w = param(dense_init(gen, (cfg.conv_kernel, cdim), dt,
                                       scale=0.5, device=device))
        self.conv_b = param(torch.zeros((cdim,), dtype=dt, device=device))
        self.A_log = param(torch.log(torch.arange(
            1, nh + 1, dtype=torch.float32, device=device)))
        self.D = param(torch.ones((nh,), dtype=torch.float32, device=device))
        # dt_bias so that softplus(dt_bias) ~ U[1e-3, 1e-1] (mamba2's)
        u = torch.empty((nh,), dtype=torch.float32, device=device)
        if u.device.type != "meta":
            u.uniform_(1e-3, 1e-1, generator=gen)
        self.dt_bias = param(u + torch.log(-torch.expm1(-u)))
        self.norm = param(torch.ones((di,), dtype=dt, device=device))
        self.w_out = param(dense_init(gen, (di, d), dt, device=device))


def specs(cfg):
    return {
        "w_in": ("embed", "inner_all"),
        "conv_w": (None, "conv_dim"),
        "conv_b": ("conv_dim",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("inner",),
        "w_out": ("inner", "embed"),
    }


def init(gen, cfg, device="cuda") -> Mamba2:
    return Mamba2(cfg, gen, device=device)


def _causal_conv(u, w, b, init_state=None):
    """Depthwise causal conv. u: (B, S, C); w: (k, C) -> (B, S, C).
    init_state: (B, k-1, C) history, or None for zeros."""
    k = w.shape[0]
    if init_state is None:
        pad = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    else:
        pad = init_state.to(u.dtype)
    x = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = x[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + x[:, i:i + S] * w[i]
    return out + b


def _split(cfg, zxbcdt):
    di, nh, _ = dims(cfg)
    N = cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt_raw


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_out(p, y, z, x_dtype, cfg):
    """rms_norm((y * silu(z)) in the working dtype) @ w_out."""
    y = rms_norm((y * F.silu(z.float())).to(x_dtype), p.norm, cfg.norm_eps)
    return y @ p.w_out


def _core(xBC, dt_raw, conv_w, conv_b, dt_bias, A_log, D, conv_state,
          ssm_state, cfg, heads=slice(None)):
    """The causal conv, the gates and the chunked SSD scan of the heads
    `heads` (dt_bias, A_log and D are theirs; the ssm state too). xBC,
    dt_raw: the input projection's slices (B, S, .). Returns (y (B, S,
    H_l, P) float32 with the D skip, the state after the last chunk)."""
    B, S, _ = xBC.shape
    di, nh, _ = dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_headdim
    Q = min(CHUNK, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    xBC = F.silu(_causal_conv(xBC, conv_w, conv_b, conv_state))
    xc = xBC[..., :di].reshape(B, S, nh, P)[:, :, heads]
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()

    dtv = _softplus(dt_raw[..., heads].float() + dt_bias)    # (B, S, H)
    A = -torch.exp(A_log)                                    # (H,) < 0
    da = dtv * A                                             # <= 0

    def chunk(t, c):
        return t[:, c * Q:(c + 1) * Q]

    xcf = xc.float()
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xBC.device))
    state = xcf.new_zeros((B, dtv.shape[-1], P, N)) \
        if ssm_state is None else ssm_state
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, daq = (chunk(t, c) for t in (xcf, Bm, Cm, dtv, da))
        cum = torch.cumsum(daq, dim=1)                        # (B, Q, H)
        # intra-chunk: w[b,i,j,h] = (C_i . B_j) exp(cum_i - cum_j) dt_j
        cb = torch.einsum("bqn,bsn->bqs", Cq, Bq)             # (B, Q, Q)
        # masked (j > i) exponents are set to -inf before exp: their
        # cum_i - cum_j >= 0 can overflow to inf, which leaves the
        # forward's masked zeros as they are but makes the backward's
        # 0 * inf a NaN
        dec = torch.exp(torch.where(causal[None, :, :, None],
                                    cum[:, :, None, :] - cum[:, None, :, :],
                                    -torch.inf))
        w = cb[..., None] * dec * dtq[:, None, :, :]
        w = torch.where(causal[None, :, :, None], w, 0.0)
        y = torch.einsum("bqsh,bshp->bqhp", w, xq)
        # inter-chunk: the incoming state's contribution
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", Cq, state,
                             torch.exp(cum))
        rem = torch.exp(cum[:, -1:, :] - cum)                 # exp(cum_Q - cum_j)
        st = torch.einsum("bqh,bqn,bqhp->bhpn", rem * dtq, Bq, xq)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + st
        ys.append(y)
    y = torch.cat(ys, dim=1)                                  # (B, S, H, P)
    return y + D[None, None, :, None] * xcf, state


def _mesh_core(p, xBC, dt_raw, conv_state, ssm_state, cfg):
    """`_core` of DTensors, per rank through `local_map`: the batch over
    the data axes, the heads over 'model' (the reference's ssm_heads),
    each where it divides them; the conv runs whole on every rank of a
    head group (its weights are small). Zero collectives inside."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.mesh import coordinate
    mesh = xBC.device_mesh
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    nh = dims(cfg)[1]
    m = sizes.get("model", 1)
    n_data = math.prod(v for a, v in sizes.items() if a != "model")
    split = xBC.shape[0] % n_data == 0
    by_head = "model" in names and nh % m == 0
    nh_l = nh // m if by_head else nh
    h0 = coordinate(mesh, ["model"]) * nh_l if by_head else 0

    def pl(batch_dim, head_dim, other=Replicate()):
        return tuple((Shard(batch_dim) if split and batch_dim is not None
                      else other) if a != "model" else
                     (Shard(head_dim) if by_head and head_dim is not None
                      else Replicate()) for a in names)
    part = tuple(Partial() if (split if a != "model" else by_head)
                 else Replicate() for a in names)
    x_pl, x_grad = pl(0, None), tuple(
        Shard(0) if split and a != "model" else g
        for a, g in zip(names, part))
    w_pl = pl(None, None)
    h_pl = pl(None, 0)
    h_grad = tuple(Partial() if split and a != "model" else q
                   for a, q in zip(names, h_pl))
    states = tuple(t for t in (conv_state, ssm_state) if t is not None)
    st_pl = tuple(pl(0, None if t is conv_state else 1) for t in states)
    heads = slice(h0, h0 + nh_l)

    def fn(xl, dl, conv_w, conv_b, dt_bias, A_log, D, *st):
        cs = st[0] if conv_state is not None else None
        ss = st[-1] if ssm_state is not None else None
        return _core(xl, dl, conv_w, conv_b, dt_bias, A_log, D, cs, ss,
                     cfg, heads)

    return local_map(
        fn, out_placements=(pl(0, 2), pl(0, 1)),
        in_placements=(x_pl, x_pl, w_pl, w_pl, h_pl, h_pl, h_pl) + st_pl,
        in_grad_placements=(x_grad, x_grad, part, part, h_grad, h_grad,
                            h_grad) + st_pl,
        device_mesh=mesh, redistribute_inputs=True)(
            xBC, dt_raw, p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D,
            *states)


def apply(p, x, cfg, conv_state=None, ssm_state=None, return_state=False):
    """x: (B, S, d_model) -> (B, S, d_model), chunked SSD. With
    `return_state` also returns (conv_state (B, k-1, cdim), ssm_state
    (B, H, P, N) float32) to continue from in decode. Under a mesh the
    conv and the chunk scan run per rank (`_mesh_core`)."""
    B, S, d = x.shape
    p = Gathered(p)
    di, nh, cdim = dims(cfg)

    # laid out (and its gradient too) as the rules lay out inner_all
    zxbcdt = shard_act(x @ p.w_in, "batch", "seq", "inner_all")
    z, xBC, dt_raw = _split(cfg, zxbcdt)
    if is_dtensor(zxbcdt):
        y, state = _mesh_core(p, xBC, dt_raw, conv_state, ssm_state, cfg)
    else:
        y, state = _core(xBC, dt_raw, p.conv_w, p.conv_b, p.dt_bias,
                         p.A_log, p.D, conv_state, ssm_state, cfg)
    out = shard_act(_gated_out(p, y.reshape(B, S, di), z, x.dtype, cfg),
                    "batch", "seq", "embed")
    if return_state:
        k = cfg.conv_kernel
        pad = xBC.new_zeros((B, max(k - 1 - S, 0), cdim))
        raw = x[:, max(S - (k - 1), 0):] @ p.w_in
        _, hist, _ = _split(cfg, raw)
        return out, torch.cat([pad, hist], dim=1), state
    return out


def decode_step(p, x, conv_state, ssm_state, cfg):
    """x: (B, 1, d); conv_state: (B, k-1, cdim) pre-activation history;
    ssm_state: (B, H, P, N) float32. Returns (out (B, 1, d), conv_state,
    ssm_state), new tensors."""
    B = x.shape[0]
    p = Gathered(p)
    di, nh, cdim = dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_headdim

    zxbcdt = x @ p.w_in
    z, xBC_raw, dt_raw = _split(cfg, zxbcdt)
    hist = torch.cat([conv_state.to(xBC_raw.dtype), xBC_raw], dim=1)
    conv_state = hist[:, 1:]
    xBC = F.silu(torch.einsum("bkc,kc->bc", hist, p.conv_w) + p.conv_b)
    xc = xBC[:, :di].reshape(B, nh, P).float()
    Bm = xBC[:, di:di + N].float()
    Cm = xBC[:, di + N:].float()

    dtv = _softplus(dt_raw[:, 0].float() + p.dt_bias)         # (B, H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dtv * A)
    ssm_state = ssm_state * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtv, Bm, xc)
    y = torch.einsum("bn,bhpn->bhp", Cm, ssm_state) \
        + p.D[None, :, None] * xc
    out = shard_act(_gated_out(p, y.reshape(B, 1, di), z, x.dtype, cfg),
                    "batch", "seq", "embed")
    return out, conv_state, ssm_state
