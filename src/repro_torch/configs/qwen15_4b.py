"""qwen1.5-4b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    block_pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    qkv_bias=True,
    long_context="sliding_window",
    source="hf:Qwen/Qwen1.5-0.5B",
)
