"""Public entry of the flash-attention kernel (port of
`repro.kernels.flash_attention.ops`).

A CUDA tensor launches, through `kernel.flash_attention_fwd`, the
tensor-core kernel `csrc/flash_attention_tc.cu` when it is bfloat16 and
`csrc/flash_attention.cu` when it is float32 (or raises); a CPU tensor
runs the plain blocked version `kernel.flash_attention_plain` with chunks
of `bq` queries and `bkv` keys. The reference pads Sq and Skv to its blocks and
leaves padded keys unmasked when q_offset + Sq > Skv; the port pads
nothing and masks by bounds and by `kv_len`. The kernels pick their own
tiles, so `bq` shapes only the plain version; the plain version and the
bf16 kernel refresh the running softmax max once per `bkv` keys, the
float32 kernel once per key tile (`kernel.F32_KEY_TILE`), which at float32
moves only rounding. All three take the model's sliding `window` and any
head_dim that is a multiple of 8 up to 256. Under autograd (grad mode on
and q, k or v requiring grad) the call goes through the autograd Function
`kernel.FlashAttention`: the same forward, and a plain-torch tiled
backward (`kernel.flash_attention_bwd`).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel


def flash_attention(q, k, v, q_offset=0, *, bq=256, bkv=512, causal=True,
                    window=0, kv_len=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) -> (B, Sq, H, hd)."""
    return kernel.flash_attention(q, k, v, q_offset, causal=causal,
                                  window=window, kv_len=kv_len, chunk_q=bq,
                                  chunk_kv=bkv)
