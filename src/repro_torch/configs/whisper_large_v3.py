"""whisper-large-v3 [audio] — encoder-decoder; conv frontend is a stub.

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866  [arXiv:2212.04356]

32 encoder + 32 decoder layers (whisper-large is 32/32). The mel/conv
frontend is a STUB: input_specs() provides precomputed (1500, d_model)
frame embeddings. LayerNorm + GELU, learned absolute positions, cross-attn.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    n_enc_layers=32,
    enc_frames=1500,
    norm="layernorm",
    act="gelu",
)
