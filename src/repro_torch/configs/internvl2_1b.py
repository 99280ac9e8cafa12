"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2-ish backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655  [arXiv:2404.16821; hf]

The vision tower is a STUB: input_specs() provides precomputed
(n_patches=256, d_model) patch embeddings which are prepended to the
text-token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    n_patches=256,
    rope_theta=1000000.0,
)
