"""Plain float32 building blocks of the benchmark's reference models.

Plain PyTorch only: nothing here imports the program (`repro_torch`), the
JAX package or any kernel. Float32 products run with TF32 off
(`full_precision`), so they are IEEE float32 sums on the card too.

`precision="fp8"` is the control of the correctness check (and "bf16" a
witness of the configurations' own rounding), never used by a benchmark
run: every matrix product's operands are rounded to float8
e4m3 (weights per output column, activations per row, each scaled to the
format's largest value 448) before a float32 product, the step below the
bf16 that the configurations state.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def full_precision():
    """Float32 products in float32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (the scale maps the slice's largest magnitude to 448), back in
    float32."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # the rounded value forward; under autograd the gradient passes
    # straight through the rounding, as in fp8 training
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32"):
    """x (..., k) @ w (k, n) in float32; with "fp8" both operands rounded
    first (x per row, w per output column); with "bf16" both rounded to
    bfloat16 (the configurations' own precision, a witness of what its
    rounding alone does)."""
    if precision == "fp8":
        x = fp8_round(x, -1)
        w = fp8_round(w, 0)
    elif precision == "bf16":
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x (T, heads, hd) rotated by the half-split rotary embedding at
    integer `positions` (T,); angles in float64, then float32."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = positions.to(torch.float64)[:, None] * inv[None]
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, *, window: int = 0, block: int = 1024):
    """Causal attention of one sequence: q (T, H, hd), k and v (T, K, hd),
    H a multiple of K (query head h reads kv head h // (H / K)). Query i
    sees key j when j <= i and, with a window, i - j < window. Exact
    softmax over each block of `block` queries at a time."""
    T, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    kk = k.repeat_interleave(G, dim=1).permute(1, 0, 2)   # (H, T, hd)
    vv = v.repeat_interleave(G, dim=1).permute(1, 0, 2)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, T, block):
        b = min(a + block, T)
        lo = max(0, a - window + 1) if window else 0
        s = torch.einsum("qhd,hkd->hqk", q[a:b], kk[:, lo:b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        keep = kj <= qi
        if window:
            keep = keep & (qi - kj < window)
        s = s.masked_fill(~keep[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("hqk,hkd->qhd", p, vv[:, lo:b])
    return out
