"""GQA flash-attention forward, causal or not, as two CUDA kernels, one per
dtype, and its plain PyTorch version.

Replaces the Pallas kernel `repro.kernels.flash_attention.kernel`
(`flash_attention_fwd`, body `_kernel`): online softmax over key tiles
with float32 scores, running max, row sum and accumulator, so no (Sq, Skv)
score matrix reaches device memory. p is rounded to V's type before the
PV product, as the model's blocked flash attention does
(`repro/models/attention.py:137-141`); at float32 that is the identity.
Keys at or beyond `kv_len`, after the query where `causal`, and `window`
or more positions before it where `window` > 0, are masked to -1e30, the
mask of the model's flash attention (`repro/models/attention.py:144-147`;
the Pallas kernel itself has no window). Both kernels take any head_dim
that is a multiple of 8 from 8 to 256: they pad it with zeros to a
multiple of 16 inside the launch, which changes no sum; nothing else is
padded.

Which kernel serves which dtype (`route` decides, from q's dtype):
- bfloat16: `csrc/flash_attention_tc.cu`, on the tensor cores (mma.sync
  bf16 with float32 sums, cp.async K/V staging), launched by
  `flash_attention_tc`, counted in `flash_attention_tc.launches`;
- float32: `csrc/flash_attention.cu`, on the float32 CUDA cores (TF32
  would break the reference's float32 contract; register-tiled Q K^T and
  P V, cp.async K/V staging), launched by `flash_attention_f32`, counted
  in `flash_attention_f32.launches`.

`flash_attention_fwd` is one torch operator,
`repro_torch::flash_attention_fwd` (so a dispatch mode, the dry run's
analyzer, sees each call once): it launches one of them for CUDA tensors
and raises if the arguments, the build or the launch fail; fake and meta
tensors (a dry run) get the output's shape and dtype and launch nothing,
since they hold no data; CPU tensors take
`flash_attention_plain`, the blocked pure-torch attention of
`repro/models/attention.py:75-165` (chunks of `chunk_q` queries and
`chunk_kv` keys, the same float32 online softmax and the same rounding of
p). Refresh schedule of the running max: the plain version and the bf16
kernel refresh it once per chunk of `chunk_kv` keys (the kernel by a first
pass over the chunk's tiles for its max), so that they round p to bf16
against the same max; the float32 kernel refreshes it once per key tile
of `F32_KEY_TILE` keys in one pass, whatever `chunk_kv`: at float32 every
schedule is the same function and moves only float32 rounding, so it
agrees with the plain version at any `chunk_kv` within the float32 limit,
and the plain version run with `chunk_kv=F32_KEY_TILE` follows its
schedule.

Under autograd (`flash_attention`, grad mode on and q, k or v requiring
grad) the forward goes through `FlashAttention`, an autograd Function:
its forward is `flash_attention_fwd` (the kernel on a CUDA tensor, the
plain version on a CPU one) and its backward is `flash_attention_bwd`,
plain torch tiled as the reference's model flash attention differentiates
(`repro/models/attention.py:104-147`: each (chunk_q, chunk_kv) tile's
scores and p recomputed, no (Sq, Skv) matrix stored). The kernels write
their result outside autograd, so a direct launch with inputs that
require grad under grad mode raises instead of returning a detached
tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256               # both sources' widest instantiation
ALIGN = 16                       # bytes; both kernels' cp.async rows
F32_KEY_TILE = 64                # keys per max refresh of the f32 kernel

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib(name: str):
    """The loaded library of `csrc/<name>.cu` with its C signatures set:
    `<name>_launch(B, Sq, Skv, H, K, hd, q_offset, kv_len, causal, window,
    chunk, q, k, v, o, stream)` and `<name>_error(code)`."""
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = [_INT] * 11 + [_PTR] * 5
        launch.restype = _INT
        error = getattr(lib, f"{name}_error")
        error.argtypes = [_INT]
        error.restype = ctypes.c_char_p
    return lib


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          kv_len=None, chunk_q=512, chunk_kv=1024):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H = K * G -> (B, Sq, H,
    hd) in q's dtype. Query i sits at position q_offset + i; keys at or
    beyond kv_len (default Skv) are masked, and with `window` > 0 keys
    `window` or more positions before the query."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    kv_len = Skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Sq, K, G, hd)
    outs = []
    for q0 in range(0, Sq, cq):
        qq = qg[:, q0:q0 + cq].float()
        n_q = qq.shape[1]
        qpos = q_offset + torch.arange(q0, q0 + n_q, device=dev)
        m = torch.full((B, K, G, n_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, n_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, n_q, hd), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, ckv):
            kk, vv = k[:, k0:k0 + ckv], v[:, k0:k0 + ckv]
            kpos = torch.arange(k0, k0 + kk.shape[1], device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qq, kk.float()) * scale
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            else:
                mask = torch.ones((n_q, kk.shape[1]), dtype=torch.bool,
                                  device=dev)
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            mask &= (kpos < kv_len)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p32 = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p32.sum(dim=-1)
            p = p32.to(vv.dtype).float()
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vv.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, n_q, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _launch(name: str, q, k, v, args):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            f"{name} writes its result outside autograd, so it would "
            f"return a tensor with no gradient; call "
            f"kernels.flash_attention.ops.flash_attention (the autograd "
            f"Function) instead")
    index = q.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, q, k, v, args)
    lib = _lib(name)
    out = torch.empty_like(q)
    rc = getattr(lib, f"{name}_launch")(
        *args, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, f"{name}_error")(rc).decode())
    return out


def flash_attention_tc(q, k, v, args):
    """Launch `csrc/flash_attention_tc.cu` on bf16 CUDA tensors checked by
    `route`, with its int arguments `args`; counts the launch, and in
    `noncausal_launches` a launch with causal = 0."""
    out = _launch("flash_attention_tc", q, k, v, args)
    flash_attention_tc.launches += 1
    flash_attention_tc.noncausal_launches += not args[8]
    return out


def flash_attention_f32(q, k, v, args):
    """Launch `csrc/flash_attention.cu` on float32 CUDA tensors checked by
    `route`, with its int arguments `args`; counts the launch, and in
    `noncausal_launches` a launch with causal = 0."""
    out = _launch("flash_attention", q, k, v, args)
    flash_attention_f32.launches += 1
    flash_attention_f32.noncausal_launches += not args[8]
    return out


flash_attention_tc.launches = flash_attention_tc.noncausal_launches = 0
flash_attention_f32.launches = flash_attention_f32.noncausal_launches = 0


def _route_args(q, k, v, q_offset=0, *, causal=True, window=0, kv_len=None,
                chunk_kv=1024) -> tuple:
    """The checks of `route` that read no data (shapes, dtypes, devices)
    and the kernels' int arguments."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B, Sq, H, hd) and k, v "
                         f"(B, Skv, K, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else int(kv_len)
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernels take a head_dim that is "
                         f"a multiple of 8 from 8 to {MAX_HEAD_DIM} (16-byte "
                         f"bf16 rows); got {hd}")
    if H % K:
        raise ValueError(f"flash_attention kernel takes H a multiple of K "
                         f"(whole query heads per kv head); got H={H}, "
                         f"K={K}")
    if not 1 <= kv_len <= Skv or q_offset < 0 or min(B, Sq, Skv) < 1 \
            or chunk_kv < 1 or window < 0:
        raise ValueError(f"flash_attention kernel takes 1 <= kv_len <= Skv, "
                         f"q_offset >= 0, chunk_kv >= 1, window >= 0 and "
                         f"nonempty inputs; got kv_len={kv_len}, Skv={Skv}, "
                         f"q_offset={q_offset}, chunk_kv={chunk_kv}, "
                         f"window={window}, B={B}, Sq={Sq}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    # one chunk of Skv keys is the same as any longer one, and fits an int
    return (B, Sq, Skv, H, K, hd, int(q_offset), kv_len, int(bool(causal)),
            int(window), min(int(chunk_kv), Skv))


def route(q, k, v, q_offset=0, *, causal=True, window=0, kv_len=None,
          chunk_kv=1024):
    """The kernel wrapper that serves q's dtype (`flash_attention_tc` for
    bfloat16, `flash_attention_f32` for float32) and its int arguments
    (B, Sq, Skv, H, K, hd, q_offset, kv_len, causal, window, chunk), after
    the checks both kernels need; raises on what neither takes. Does not
    look at the device, so that it runs on CPU tensors too."""
    args = _route_args(q, k, v, q_offset, causal=causal, window=window,
                       kv_len=kv_len, chunk_kv=chunk_kv)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if any(x.data_ptr() % ALIGN for x in (q, k, v)):
        raise ValueError(f"flash_attention kernels take q, k, v aligned to "
                         f"{ALIGN} bytes")
    kern = (flash_attention_tc if q.dtype == torch.bfloat16
            else flash_attention_f32)
    return kern, args


@torch.library.custom_op("repro_torch::flash_attention_fwd",
                         mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int, causal: bool, window: int,
                  kv_len: Optional[int], chunk_q: int,
                  chunk_kv: int) -> torch.Tensor:
    """The flash entry as one torch operator, so that a dispatch mode sees
    each call once (`launch.hlo_analysis`). CPU tensors: the plain
    version."""
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 chunk_q=chunk_q, chunk_kv=chunk_kv)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, q_offset, causal, window, kv_len, chunk_q,
                    chunk_kv):
    kern, args = route(q, k, v, q_offset, causal=causal, window=window,
                       kv_len=kv_len, chunk_kv=chunk_kv)
    return kern(q, k, v, args)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_offset, causal, window, kv_len, chunk_q,
                    chunk_kv):
    """Fake and meta tensors hold no data: the output's shape and dtype,
    after the checks a CUDA launch makes on shapes; nothing launches."""
    if q.device.type == "cuda":
        _route_args(q, k, v, q_offset, causal=causal, window=window,
                    kv_len=kv_len, chunk_kv=chunk_kv)
    return q.new_empty(q.shape)


def flash_attention_fwd(q, k, v, q_offset=0, *, causal=True, window=0,
                        kv_len=None, chunk_q=512, chunk_kv=1024):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd), contiguous, all float32 or
    all bfloat16 -> (B, Sq, H, hd). The one place that chooses between the
    kernels and the plain version, through the operator
    `repro_torch::flash_attention_fwd`: CPU tensors run
    `flash_attention_plain` (with `window`, `chunk_q` and `chunk_kv`), CUDA
    tensors launch the kernel `route` picks for their dtype, which picks
    its own tiles and skips the key tiles that lie wholly before every
    query's `window`; the bf16 kernel refreshes the running max once per
    `chunk_kv` keys, the float32 one once per `F32_KEY_TILE` keys. Fake
    and meta tensors (a dry run) get the output's shape and dtype and
    launch nothing."""
    return _flash_fwd_op(q, k, v, int(q_offset), bool(causal), int(window),
                         None if kv_len is None else int(kv_len),
                         int(chunk_q), int(chunk_kv))


def visited_work(Sq, Skv, *, q_offset=0, causal=True, window=0,
                 kv_len=None, chunk_q=512, chunk_kv=1024) -> tuple:
    """(pairs, tiles): the (chunk_q, chunk_kv) tiles that hold a (query,
    key) pair some query may see, and the pairs in them, whole tiles
    counted: the work of one head's blocked flash attention
    (`launch.hlo_analysis` counts 4 * hd operations a pair and two
    products a tile)."""
    kv_len = Skv if kv_len is None else kv_len
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    pairs = tiles = 0
    for q0 in range(0, Sq, cq):
        n_q = min(cq, Sq - q0)
        first, last = q_offset + q0, q_offset + q0 + n_q - 1
        for k0 in range(0, Skv, ckv):
            n_k = min(ckv, Skv - k0)
            if _visited(k0, n_k, first, last, causal, window, kv_len):
                pairs += n_q * n_k
                tiles += 1
    return pairs, tiles


def _visited(k0, n_k, q_first, q_last, causal, window, kv_len):
    """Whether key chunk [k0, k0 + n_k) holds a key that some query in
    [q_first, q_last] may see: a wholly masked chunk adds exact zeros to
    every sum of the backward (and leaves the running max as it was), so
    skipping it changes no bit."""
    if k0 >= kv_len or (causal and k0 > q_last):
        return False
    return not (window and q_first - (k0 + n_k - 1) >= window)


def flash_attention_bwd(q, k, v, o, do, *, causal=True, window=0,
                        q_offset=0, kv_len=None, chunk_q=512, chunk_kv=1024):
    """Gradients (dq, dk, dv) of `flash_attention_plain`'s output `o` =
    attention(q, k, v) for the output gradient `do`, in plain torch.

    Per chunk of `chunk_q` queries: a first pass over the key chunks
    recomputes the forward's running max (kept per chunk, since p is
    rounded to V's dtype against it) and row sum; D = rowsum(do * o);
    a second pass recomputes each tile's p = exp(s - m) / l and adds
    dV += p_fwd^T dO (p_fwd the forward's weights, rounded as it rounds
    them), dS = p * (dO V^T - D), dQ += dS K and dK += dS^T Q (both times
    the softmax scale). Float32 throughout, in batched matrix products
    over (batch x kv head) with the query group folded into the rows, so
    K/V gradients sum over each kv head's group; the scale, the D shift
    and the accumulations ride in the products, and the rest runs in
    place. The causal, window and kv_len mask is the forward's, applied
    only to tiles it touches; key chunks that no query of the chunk sees
    are skipped. Returns tensors in the dtypes of q, k and v."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    BK = B * K
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    kv_len = Skv if kv_len is None else int(kv_len)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    f32 = torch.float32
    round_p = v.dtype != f32

    def rows(x, a, b):
        """(B, S, H, hd)[:, a:b] -> (B * K, G * n, hd) float32, rows of a
        kv head's group one after another."""
        n = b - a
        return x[:, a:b].reshape(B, n, K, G, hd).permute(0, 2, 3, 1, 4) \
            .reshape(BK, G * n, hd).float()

    def heads(x):
        """(B, S, K, hd) -> (B * K, S, hd) float32."""
        return x.permute(0, 2, 1, 3).reshape(BK, x.shape[1], hd).float()

    kb, vb = heads(k), heads(v)
    dq = torch.empty((B, Sq, K, G, hd), dtype=f32, device=dev)
    dk = torch.zeros((BK, Skv, hd), dtype=f32, device=dev)
    dv = torch.zeros((BK, Skv, hd), dtype=f32, device=dev)

    for q0 in range(0, Sq, cq):
        n_q = min(cq, Sq - q0)
        qb, db = rows(q, q0, q0 + n_q), rows(do, q0, q0 + n_q)
        neg_d = -(db * rows(o, q0, q0 + n_q)).sum(-1, keepdim=True)
        q_first, q_last = q_offset + q0, q_offset + q0 + n_q - 1
        qpos = torch.arange(q_first, q_last + 1, device=dev)
        chunks = [(k0, min(ckv, Skv - k0)) for k0 in range(0, Skv, ckv)
                  if _visited(k0, min(ckv, Skv - k0), q_first, q_last,
                              causal, window, kv_len)]

        def scores(k0, n_k):
            """scale * Q K^T of the tile, (B*K, G*n_q, n_k), masked."""
            s = torch.empty((BK, G * n_q, n_k), dtype=f32, device=dev)
            torch.baddbmm(s, qb, kb[:, k0:k0 + n_k].transpose(1, 2),
                          beta=0.0, alpha=scale, out=s)
            if (k0 + n_k > kv_len or (causal and k0 + n_k - 1 > q_first)
                    or (window and q_last - k0 >= window)):
                kpos = torch.arange(k0, k0 + n_k, device=dev)
                keep = (kpos < kv_len)[None, :].expand(n_q, n_k)
                if causal:
                    keep = keep & (kpos[None, :] <= qpos[:, None])
                if window:
                    keep = keep & ((qpos[:, None] - kpos[None, :]) < window)
                s.view(BK, G, n_q, n_k).masked_fill_(~keep, NEG_INF)
            return s

        m = torch.full((BK, G * n_q, 1), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((BK, G * n_q, 1), dtype=f32, device=dev)
        m_run = []
        for k0, n_k in chunks:
            s = scores(k0, n_k)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) \
                + s.sub_(m_new).exp_().sum(dim=-1, keepdim=True)
            m = m_new
            m_run.append(m)
        inv_l = 1.0 / torch.clamp_min(l, 1e-30)

        dqb = torch.zeros_like(qb)
        for (k0, n_k), m_c in zip(chunks, m_run):
            s = scores(k0, n_k)
            if round_p:
                # the forward's weights: exp(s - m_c) rounded to V's
                # dtype, carried to the final max by exp(m_c - m)
                to_final = torch.exp(m_c - m) * inv_l
                e = s.sub_(m_c).exp_()
                p_fwd = e.to(v.dtype).float().mul_(to_final)
                p = e.mul_(to_final)
            else:
                p = p_fwd = s.sub_(m).exp_().mul_(inv_l)
            dv[:, k0:k0 + n_k].baddbmm_(p_fwd.transpose(1, 2), db)
            ds = torch.baddbmm(neg_d, db, vb[:, k0:k0 + n_k].transpose(1, 2))
            ds.mul_(p)
            dqb.baddbmm_(ds, kb[:, k0:k0 + n_k], alpha=scale)
            dk[:, k0:k0 + n_k].baddbmm_(ds.transpose(1, 2), qb, alpha=scale)
        dq[:, q0:q0 + n_q] = dqb.view(B, K, G, n_q, hd).permute(0, 3, 1, 2, 4)
    back = lambda x: x.view(B, K, Skv, hd).permute(0, 2, 1, 3)  # noqa: E731
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), back(dk).to(k.dtype),
            back(dv).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: forward `flash_attention_fwd` (the
    kernel `route` picks on a CUDA tensor, `flash_attention_plain` on a
    CPU one), backward `flash_attention_bwd` from the saved q, k, v and
    output."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, kv_len, chunk_q,
                chunk_kv):
        o = flash_attention_fwd(q, k, v, q_offset, causal=causal,
                                window=window, kv_len=kv_len,
                                chunk_q=chunk_q, chunk_kv=chunk_kv)
        ctx.save_for_backward(q, k, v, o)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len, chunk_q=chunk_q, chunk_kv=chunk_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_offset=0, *, causal=True, window=0,
                    kv_len=None, chunk_q=512, chunk_kv=1024):
    """`flash_attention_fwd`, through `FlashAttention` when grad mode is on
    and q, k or v requires grad (on either device), so the output carries
    a gradient; outside autograd the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_offset, causal, window,
                                    kv_len, chunk_q, chunk_kv)
    return flash_attention_fwd(q, k, v, q_offset, causal=causal,
                               window=window, kv_len=kv_len, chunk_q=chunk_q,
                               chunk_kv=chunk_kv)
