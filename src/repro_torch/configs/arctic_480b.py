"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True,
                  expert_d_ff=4864),
    long_context="sliding_window",
    source="hf:Snowflake/snowflake-arctic-base",
)
