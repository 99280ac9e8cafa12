"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]

Optimizer: Adafactor (factored second moment, bf16 first moment) so
optimizer state fits per-device HBM at 480B scale (see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_ff=4864,           # dense residual path (dense-MoE hybrid)
    capacity_factor=1.0,
    optimizer="adafactor",
    remat="full",
    rope_theta=10000.0,
)
