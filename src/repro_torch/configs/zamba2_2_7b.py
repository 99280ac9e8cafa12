"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Modeling notes (DESIGN.md §Arch-applicability): one SHARED attention+MLP
block (single weight set) is applied every 6 Mamba2 layers; Zamba2's
per-application LoRA deltas are omitted.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    conv_kernel=4,
    attn_every=6,
    rope_theta=10000.0,
)
