"""llava-next-mistral-7b [vlm] — anyres tiling stubbed to patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=1000000.0,
    # anyres: base 576 patches + up to 4 tiles x 576 = 2880 image tokens,
    # delivered pre-projected by the stubbed ViT+projector frontend.
    vision_tokens=2880,
    long_context="sliding_window",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
