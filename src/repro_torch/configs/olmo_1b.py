"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    block_pattern=("attn",),
    norm="layernorm_np",         # non-parametric LN (no scale/bias)
    ffn="swiglu",
    tie_embeddings=True,
    long_context="sliding_window",
    source="arXiv:2402.00838",
)
