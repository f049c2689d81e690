"""jamba-v0.1-52b [hybrid] — Mamba:attn 1:7 interleave, MoE 16e top-2 on
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # 8-layer jamba block: attn at index 4 of each group, 7 mamba layers
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    norm="rmsnorm",
    ffn="swiglu",
    pos_emb="none",              # jamba uses no positional encoding
    moe=MoEConfig(num_experts=16, top_k=2, every_n_layers=2),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    long_context="native",
    source="arXiv:2403.19887",
)
