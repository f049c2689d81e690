"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,            # MLA: latent cache, kv heads == q heads logically
    d_ff=1536,                   # per-expert ffn dim
    vocab_size=102400,
    head_dim=192,                # qk_nope(128) + qk_rope(64)
    block_pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  expert_d_ff=1536),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128),
    long_context="sliding_window",
    source="arXiv:2405.04434",
)
