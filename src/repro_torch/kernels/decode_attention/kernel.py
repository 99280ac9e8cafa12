"""Decode attention: one new query token per cache slot against the slot's
KV cache, as a CUDA kernel and its plain PyTorch version.

The JAX package has no kernel here: its decode attention
(`repro/models/attention.py`, `decode`) is two einsums over the whole
cache window under a mask. `decode_attention_plain` is that computation
as the port ran it (float32 scores from the working dtype's operands, the
softmax of `common.softmax_last`, the weights rounded to q's dtype before
P V); the CPU tests hold it to the reference, and a DTensor cache (the
mesh decode, whose `kv_seq` may be sharded) runs it. On a CUDA cache it
copied every layer's whole K cache to float32 and both einsums made
permuted copies of K and V; `decode_attention` launches
`csrc/decode_attention.cu` instead, which reads the cache in place and
only its filled rows: `filled_rows(pos, W) = min(pos + 1, W)` a slot, the
rows the plain version's mask keeps in clamp and in ring mode. See the
source's note for its design and its byte bound.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.common import softmax_last

NEG_INF = -1e30
SPLIT_ROWS = 256           # cache rows a block reads: the source's SPLIT_ROWS
MAX_GROUP = 8              # query heads a kv head, the widest instantiation
MAX_HEAD_DIM = 256
MAX_SPLITS = 1024          # the source's MAX_SPLITS: W <= 262,144 rows
# dtype codes of the C interface: q and cache, and the int8 cache
_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    """The loaded library of `csrc/decode_attention.cu` with its C
    signatures set: `decode_attention_launch(B, W, H, K, hd, q_dtype,
    c_dtype, pos64, n_split, scale, q, k, v, ks, vs, pos, part, out,
    stream)` and `decode_attention_error(code)`."""
    lib = build.load("decode_attention")
    launch = lib.decode_attention_launch
    if launch.argtypes is None:
        launch.argtypes = [_INT] * 9 + [ctypes.c_float] + [_PTR] * 9
        launch.restype = _INT
        lib.decode_attention_error.argtypes = [_INT]
        lib.decode_attention_error.restype = ctypes.c_char_p
    return lib


def filled_rows(pos, W):
    """The rows of each slot's cache that decode at `pos` attends to,
    min(pos + 1, W): in clamp mode rows 0..min(pos, W - 1), in ring mode
    rows 0..pos % W, or all W once pos >= W (the ring's order does not
    matter to a softmax)."""
    return torch.clamp_max(pos.long() + 1, W)


def n_splits(W: int) -> int:
    """The kernel's blocks along the cache, from its window alone."""
    return -(-W // SPLIT_ROWS)


def decode_attention_plain(q, cache_k, cache_v, pos, *, ring=False,
                           scales=None):
    """q: (B, 1, H, hd); cache_k, cache_v: (B, W, K, hd); pos: (B,) the
    current index, whose row is already written. Attends each slot's query
    to rows <= pos % W (`ring`; every row once pos >= W) or <= min(pos, W -
    1). `scales`: (ks, vs), each (B, W, K) bf16, for int8 caches: they
    multiply the float32 scores and the softmax weights. Returns (B, 1, H,
    hd) in q's dtype."""
    B, W = cache_k.shape[:2]
    H, hd = q.shape[2], q.shape[3]
    K = cache_k.shape[2]
    pos = pos.long()
    slot = pos % W if ring else torch.clamp_max(pos, W - 1)
    qg = q.reshape(B, K, H // K, hd)
    # float32 scores from the working dtype's operands
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cache_k.to(q.dtype).float()) / math.sqrt(hd)
    if scales is not None:
        ks, vs = scales
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    slots = torch.arange(W, device=q.device)[None]
    valid = slots <= slot[:, None]
    if ring:
        valid = valid | (pos[:, None] >= W)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = softmax_last(s)
    if scales is not None:
        w = w * vs.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskh->bkgh", w.to(q.dtype),
                     cache_v.to(q.dtype))
    return o.reshape(B, 1, H, hd)


def launch_args(q, cache_k, cache_v, pos, scales=None) -> tuple:
    """The kernel's checks that read no data (shapes, dtypes, layout,
    devices) and its int arguments (B, W, H, K, hd, q_dtype, c_dtype,
    pos64, n_split); raises on what the kernel does not take. Does not
    look at the device type, so that it runs on CPU tensors too."""
    if q.ndim != 4 or q.shape[1] != 1 or cache_k.ndim != 4 \
            or cache_v.shape != cache_k.shape \
            or cache_k.shape[0] != q.shape[0] \
            or cache_k.shape[3] != q.shape[3] \
            or pos.shape != (q.shape[0],):
        raise ValueError(f"decode_attention takes q (B, 1, H, hd), caches "
                         f"(B, W, K, hd) and pos (B,); got {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}, "
                         f"{tuple(pos.shape)}")
    B, _, H, hd = q.shape
    W, K = cache_k.shape[1], cache_k.shape[2]
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes a head_dim that is "
                         f"a multiple of 8 from 8 to {MAX_HEAD_DIM} (8 "
                         f"elements a lane); got {hd}")
    if min(B, W, K) < 1 or H % K or H // K > MAX_GROUP \
            or n_splits(W) > MAX_SPLITS:
        raise ValueError(f"decode_attention kernel takes whole groups of at "
                         f"most {MAX_GROUP} query heads a kv head, at most "
                         f"{MAX_SPLITS * SPLIT_ROWS} cache rows and "
                         f"nonempty inputs; got B={B}, W={W}, H={H}, K={K}")
    int8 = cache_k.dtype == torch.int8
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or cache_v.dtype != cache_k.dtype \
            or (cache_k.dtype != q.dtype and not int8) \
            or int8 != (scales is not None) \
            or pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention kernel takes q bfloat16 or "
                        f"float32, caches of q's dtype or int8 (int8 with "
                        f"scales, no other with them), pos int32 or int64; "
                        f"got q {q.dtype}, caches {cache_k.dtype}, "
                        f"{cache_v.dtype}, scales "
                        f"{'given' if scales is not None else 'none'}, pos "
                        f"{pos.dtype}")
    tensors = [q, cache_k, cache_v, pos]
    if int8:
        ks, vs = scales
        if ks.shape != (B, W, K) or vs.shape != (B, W, K) \
                or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes int8 scales (B, "
                            f"W, K) bfloat16; got {tuple(ks.shape)} "
                            f"{ks.dtype}, {tuple(vs.shape)} {vs.dtype}")
        tensors += [ks, vs]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention kernel takes contiguous q, "
                         "caches, scales and pos")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"decode_attention kernel takes every input on q's "
                         f"device {q.device}")
    align = 8 if int8 else 16
    if q.data_ptr() % 16 or cache_k.data_ptr() % align \
            or cache_v.data_ptr() % align:
        raise ValueError(f"decode_attention kernel takes q aligned to 16 "
                         f"bytes and the caches to {align}")
    return (B, W, H, K, hd, _CODES[q.dtype], _CODES[cache_k.dtype],
            int(pos.dtype == torch.int64), n_splits(W))


def decode_attention(q, cache_k, cache_v, pos, scales=None):
    """Launch `csrc/decode_attention.cu` on CUDA tensors: q (B, 1, H, hd)
    bf16 or float32 after rotation; cache_k, cache_v (B, W, K, hd) of q's
    dtype, or int8 with `scales` (ks, vs) (B, W, K) bf16; pos (B,) int32
    or int64 on the device. Returns (B, 1, H, hd) in q's dtype: the
    softmax over each slot's `filled_rows` in float32, rounded once.
    Launches on the current stream without a host sync; counts the call in
    `decode_attention.launches`; raises on what the kernel does not take
    or on a failed launch."""
    args = launch_args(q, cache_k, cache_v, pos, scales)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel takes CUDA tensors; got "
                         f"{q.device} (the plain version is "
                         f"decode_attention_plain)")
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("decode_attention writes its result outside "
                           "autograd, so it would return a tensor with no "
                           "gradient")
    index = q.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return decode_attention(q, cache_k, cache_v, pos, scales)
    B, _, H, _, hd = args[:5]
    n_split = args[-1]
    out = torch.empty_like(q)
    part = torch.empty(B * H * n_split * (hd + 2) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    ks, vs = scales if scales is not None else (None, None)
    lib = _lib()
    rc = lib.decode_attention_launch(
        *args, 1.0 / math.sqrt(hd), q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), pos.data_ptr(),
        part.data_ptr(), out.data_ptr(), build.raw_stream(index))
    if rc != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error(rc).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
