"""Model/shape configuration system (the port's copy of
`repro.configs.base`).

Every assigned architecture is a `ModelConfig`; the four assigned input
shapes are `ShapeConfig`s. `reduced()` derives a CPU-smoke-test-sized config
of the same family (same block structure, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned shape grid (identical for every LM-family arch).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention options ---
    qkv_bias: bool = False
    sliding_window: int = 0          # >0 -> SWA (mixtral)
    rope_theta: float = 500000.0
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0            # arctic: parallel dense residual FFN
    capacity_factor: float = 1.25

    # --- SSM / hybrid (zamba2) ---
    ssm_state: int = 0               # Mamba2 d_state
    ssm_expand: int = 2
    ssm_headdim: int = 64
    conv_kernel: int = 4
    attn_every: int = 0              # zamba2: shared attn+MLP block period

    # --- xLSTM ---
    slstm_every: int = 0             # one sLSTM per group of this many blocks
    mlstm_proj_factor: float = 2.0

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 0              # stub frontend: precomputed frame embeds

    # --- vlm (internvl2) ---
    n_patches: int = 0               # stub frontend: precomputed patch embeds

    # --- numerics / norm ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- training-time knobs ---
    remat: str = "full"              # none | dots | full
    attn_seqpar: bool = True         # context-parallel flash when heads
                                     # don't divide the model axis (§Perf)
    kv_dtype: str = "bfloat16"       # "int8" -> quantized KV cache with
                                     # per-token-per-head scales (§Perf)
    optimizer: str = "adamw"         # adamw | adafactor
    schedule: str = "cosine"         # cosine | wsd

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode with bounded memory?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def shapes(self):
        """The live (non-skipped) shape list for this arch."""
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.subquadratic:
            out.append(SHAPES["long_500k"])
        return out

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            moe_dense_ff=64 if self.moe_dense_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16,
            sliding_window=32 if self.sliding_window else 0,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_frames=8 if self.enc_frames else 0,
            n_patches=4 if self.n_patches else 0,
            remat="none",
        )

    # ---- parameter counting (used by roofline MODEL_FLOPS) ----
    # counted on the meta device: shapes only, no memory
    def param_count(self) -> int:
        from repro_torch.models.model import Model
        return Model(self, device="meta").param_count()

    def active_param_count(self) -> int:
        from repro_torch.models.model import Model
        return Model(self, device="meta").param_count(active_only=True)
