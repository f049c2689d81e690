"""xlstm-1.3b [ssm] — alternating sLSTM + mLSTM blocks, no FFN.
[arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # xlstm blocks carry their own projections
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    norm="layernorm",
    ffn="none",
    pos_emb="none",
    ssm=SSMConfig(state_dim=16, chunk=128),
    long_context="native",
    source="arXiv:2405.04517",
)
