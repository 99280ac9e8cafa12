"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304  [arXiv:2405.04517]

48 layers = 6 groups x (7 mLSTM + 1 sLSTM). mLSTM is a matrix-memory
gated linear recurrence run in chunkwise-parallel form; sLSTM is a
scalar-memory recurrence run as a sequential scan (inherently serial).
d_ff=0: the mLSTM block carries its own 2x up-projection (proj_factor).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,                # qk head dim at proj_factor=2: inner=4096, hd_v=1024
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    mlstm_proj_factor=2.0,
)
