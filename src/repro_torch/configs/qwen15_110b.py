"""qwen1.5-110b [dense] — QKV bias, 80 layers. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    block_pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    qkv_bias=True,
    long_context="sliding_window",
    source="hf:Qwen/Qwen1.5-0.5B",
)
