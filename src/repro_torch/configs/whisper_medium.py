"""whisper-medium [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=("attn",),
    norm="layernorm",
    ffn="gelu",
    qkv_bias=True,
    pos_emb="learned",
    encoder_layers=24,
    encoder_seq=1500,            # stubbed mel->conv frame embeddings
    cross_attention=True,
    long_context="sliding_window",
    source="arXiv:2212.04356",
)
