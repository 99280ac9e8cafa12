"""Architecture registry: ``get_config("llama3.2-1b")`` / ``--arch`` ids
(the port's copy of `repro.configs`)."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES

from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA3_2_3B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B

REGISTRY = {
    c.name: c
    for c in [
        XLSTM_1_3B,
        ZAMBA2_2_7B,
        WHISPER_LARGE_V3,
        QWEN2_0_5B,
        MINICPM_2B,
        LLAMA3_2_3B,
        LLAMA3_2_1B,
        ARCTIC_480B,
        MIXTRAL_8X7B,
        INTERNVL2_1B,
    ]
}

ARCH_IDS = sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "ARCH_IDS", "get_config"]
