"""Architecture config registry.

``get_arch(name)`` resolves any assigned architecture id (``--arch`` flag)
to its :class:`~repro_torch.configs.base.ArchConfig`.
"""
from repro_torch.configs.base import (ArchConfig, InputShape, INPUT_SHAPES,
                                      MLAConfig, MoEConfig, SSMConfig)
from repro_torch.configs import (arctic_480b, deepseek_v2_236b, granite_8b,
                                 jamba_v01_52b, llava_next_mistral_7b,
                                 olmo_1b, paper_cnn, qwen15_110b, qwen15_4b,
                                 whisper_medium, xlstm_1_3b)

ARCHS = {
    "whisper-medium": whisper_medium.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "granite-8b": granite_8b.CONFIG,
    "qwen1.5-110b": qwen15_110b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
}

PAPER_CNN = paper_cnn.CONFIG


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "MLAConfig",
           "MoEConfig", "SSMConfig", "ARCHS", "PAPER_CNN", "get_arch",
           "get_shape"]
