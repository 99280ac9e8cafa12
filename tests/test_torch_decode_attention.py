"""Decode attention on the CPU: the plain version that `attention.decode`
runs on CPU and DTensor caches, the formula of the rows the CUDA kernel
reads (`filled_rows`), and the kernel wrapper's checks, which read no
data. The kernel itself is compared with the plain version on the card
(tests/test_torch_kernels_cuda.py)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel
from repro_torch.models import attention
from repro_torch.models.attention import (_heads_out, _project,
                                          quantize_kv, write_rows)
from repro_torch.models.common import rope, softmax_last


def _decode_as_before(p, x, cache_k, cache_v, pos, cfg, *, use_rope=True,
                      ring=False, scales=None):
    """`attention.decode` as it was before decode attention moved into
    `kernels.decode_attention` (its einsums inline): the oracle of the
    moved plain version, bit for bit."""
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
    H, hd = q.shape[2], q.shape[3]
    K = cache_k.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cache_k.to(q.dtype).float()) / math.sqrt(hd)
    if scales is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    slots = torch.arange(W, device=x.device)[None]
    valid = slots <= slot[:, None]
    if ring:
        valid = valid | (pos[:, None] >= W)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = softmax_last(s)
    if scales is not None:
        w = w * vs.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskh->bkgh", w.to(q.dtype), cache_v.to(q.dtype))
    return _heads_out(o.reshape(B, 1, H, hd), p.wo)


def _cfg(dtype, kv_dtype="bfloat16"):
    """A small GQA config: 8 query heads over 2 kv heads (G = 4), hd 16."""
    return dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               n_heads=8, n_kv_heads=2, dtype=dtype,
                               kv_dtype=kv_dtype)


def _caches(cfg, B, W, dtype, seed, int8=False):
    """Seeded caches with every row filled (rows past a slot's fill hold
    values the mask must drop, not zeros)."""
    rng = np.random.default_rng(seed)
    shape = (B, W, cfg.n_kv_heads, cfg.hd())
    if int8:
        ck, cv = (torch.as_tensor(rng.integers(-127, 128, shape),
                                  dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.as_tensor(rng.uniform(1e-3, 2e-2, shape[:3]),
                                  dtype=torch.bfloat16) for _ in range(2))
        return ck, cv, (ks, vs)
    ck, cv = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
              for _ in range(2))
    return ck, cv, None


# (dtype, int8 cache, ring, W, positions): clamp below, at and past the
# window's end, a ring before and after its wrap, int8 with its scales
CASES = [
    ("float32", False, False, 24, (0, 5, 23, 40)),
    ("bfloat16", False, False, 24, (0, 5, 23, 40)),
    ("float32", False, True, 16, (0, 3, 15, 16)),
    ("bfloat16", False, True, 16, (17, 31, 40, 100)),
    ("bfloat16", True, False, 24, (0, 7, 23, 30)),
    ("float32", True, False, 24, (1, 9, 22, 23)),
]


@pytest.mark.parametrize("dtype,int8,ring,W,positions", CASES, ids=str)
def test_plain_decode_is_the_einsum_path_bit_for_bit(dtype, int8, ring, W,
                                                     positions):
    """`attention.decode` on CPU tensors (the moved plain version) gives
    today's einsum path's output and caches bit for bit, in clamp and ring
    mode and on int8 caches."""
    cfg = _cfg(dtype, "int8" if int8 else "bfloat16")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    p = attention.init(gen, cfg, device="cpu")
    B = len(positions)
    ck, cv, scales = _caches(cfg, B, W, dt, seed=W + B, int8=int8)
    ck2, cv2 = ck.clone(), cv.clone()
    scales2 = None if scales is None else tuple(s.clone() for s in scales)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (B, 1, cfg.d_model)), dtype=dt)
    pos = torch.tensor(positions, dtype=torch.int32)
    got = attention.decode(p, x, ck, cv, pos, cfg, ring=ring, scales=scales)
    want = _decode_as_before(p, x, ck2, cv2, pos, cfg, ring=ring,
                             scales=scales2)
    assert torch.equal(got[0], want)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
    if int8:
        assert all(torch.equal(a, b) for a, b in zip(got[3], scales2))


def test_decode_on_the_cpu_launches_no_kernel(monkeypatch):
    """CPU caches take the plain version: the kernel wrapper is neither
    called nor counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel wrapper was called on the CPU")
    monkeypatch.setattr(attention, "decode_attention", refuse)
    cfg = _cfg("float32")
    p = attention.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = kernel.decode_attention.launches
    for ring in (False, True):
        ck, cv, _ = _caches(cfg, 2, 8, torch.float32, seed=1)
        x = torch.ones((2, 1, cfg.d_model))
        attention.decode(p, x, ck, cv, torch.tensor([0, 9], dtype=torch.int32),
                         cfg, ring=ring)
    assert kernel.decode_attention.launches == before


@pytest.mark.parametrize("W", [1, 2, 7, 64])
@pytest.mark.parametrize("ring", [False, True])
def test_filled_rows_is_the_old_mask(W, ring):
    """min(pos + 1, W) rows from row 0 are the rows the einsum path's mask
    keeps, for every pos on both sides of W, clamp and ring."""
    pos = torch.arange(0, 3 * W + 2)
    slot = pos % W if ring else torch.clamp_max(pos, W - 1)
    valid = torch.arange(W)[None] <= slot[:, None]
    if ring:
        valid = valid | (pos[:, None] >= W)
    rows = kernel.filled_rows(pos.int(), W)
    assert torch.equal(valid, torch.arange(W)[None] < rows[:, None])


@pytest.mark.parametrize("W,splits", [(1, 1), (256, 1), (257, 2),
                                      (4096, 16), (12336, 49)])
def test_splits_follow_the_window(W, splits):
    assert kernel.n_splits(W) == splits


def _inputs(B=2, W=40, H=8, K=2, hd=64, dtype=torch.bfloat16,
            cache=None, pos_dtype=torch.int32):
    cache = dtype if cache is None else cache
    q = torch.zeros((B, 1, H, hd), dtype=dtype)
    ck = torch.zeros((B, W, K, hd), dtype=cache)
    cv = torch.zeros((B, W, K, hd), dtype=cache)
    pos = torch.zeros((B,), dtype=pos_dtype)
    scales = ((torch.ones((B, W, K), dtype=torch.bfloat16),) * 2
              if cache == torch.int8 else None)
    return q, ck, cv, pos, scales


@pytest.mark.parametrize("kw,args", [
    ({}, (2, 40, 8, 2, 64, 0, 0, 0, 1)),
    (dict(dtype=torch.float32, W=257), (2, 257, 8, 2, 64, 1, 1, 0, 2)),
    (dict(cache=torch.int8, hd=128, pos_dtype=torch.int64),
     (2, 40, 8, 2, 128, 0, 2, 1, 1)),
    (dict(dtype=torch.float32, cache=torch.int8, H=14, K=2, hd=80),
     (2, 40, 14, 2, 80, 1, 2, 0, 1)),
])
def test_launch_args_take_the_decode_shapes(kw, args):
    assert kernel.launch_args(*_inputs(**kw)) == args


def test_launch_args_reject_what_the_kernel_does_not_take():
    bad = {
        "head_dim": _inputs(hd=20),
        "wide head_dim": _inputs(hd=264),
        "group of 16": _inputs(H=32, K=2),
        "partial group": _inputs(H=6, K=4),
        "window past the splits": _inputs(B=1, W=262145, H=1, K=1, hd=8),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            kernel.launch_args(*args)
    q, ck, cv, pos, _ = _inputs()
    for name, args in {
            "cache dtype": (q, ck.float(), cv.float(), pos, None),
            "int8 without scales": (q, ck.to(torch.int8),
                                    cv.to(torch.int8), pos, None),
            "scales on bf16": (q, ck, cv, pos, _inputs(cache=torch.int8)[4]),
            "float16": (q.half(), ck.half(), cv.half(), pos, None),
            "pos float": (q, ck, cv, pos.float(), None)}.items():
        with pytest.raises(TypeError):
            kernel.launch_args(*args)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.launch_args(q, ck.transpose(1, 2).contiguous().transpose(1, 2),
                           cv, pos, None)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(q.numel() + 1, dtype=q.dtype)
        kernel.launch_args(flat[1:].view(q.shape), ck, cv, pos, None)
    with pytest.raises(ValueError):
        kernel.launch_args(q, ck, cv, pos[:1], None)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention(q, ck, cv, pos)
