"""Architecture & run configuration dataclasses.

A copy of the reference's ``repro/configs/base.py`` in which
``param_dtype`` is a torch dtype (bfloat16 by default, float32 under
``reduced()``); the configurations themselves are data, copied as they are.

Every assigned architecture is expressed as an :class:`ArchConfig` over a
single composable block vocabulary.  ``block_pattern`` describes the layer
interleave as a repeating group, e.g. ``("attn",)`` for a pure decoder,
``("mamba",)*7 + ("attn",)`` for jamba, ``("slstm", "mlstm")`` for xlstm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0      # deepseek-v2 style always-on experts
    dense_residual: bool = False     # arctic style parallel dense FFN
    expert_d_ff: Optional[int] = None  # defaults to arch d_ff
    router_aux_loss: float = 0.01
    every_n_layers: int = 1          # MoE applied to every n-th block (jamba: 2)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16              # mamba N
    conv_width: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None    # defaults to ceil(d_model/16)
    chunk: int = 128                 # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np (non-parametric)
    ffn: str = "swiglu"              # swiglu | gelu | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_emb: str = "rope"            # rope | learned | none
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec (whisper): encoder consumes stubbed frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0             # e.g. 1500 audio frames
    cross_attention: bool = False
    # vlm: stubbed vision tiles -> patch embeddings prepended to text
    vision_tokens: int = 0           # patches per image (anyres tiles flattened)
    # long-context strategy: "native" (ssm/hybrid), "sliding_window", "skip"
    long_context: str = "sliding_window"
    sliding_window: int = 4096
    param_dtype: torch.dtype = torch.bfloat16
    source: str = ""                 # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def group_size(self) -> int:
        """Layers per repeating block group (scan unit)."""
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"block group {self.group_size}")
        return self.num_layers // self.group_size

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 groups, d_model<=256, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                num_shared_experts=min(1, self.moe.num_shared_experts),
                expert_d_ff=min(self.moe.expert_d_ff or self.d_ff, 512) or None)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                            qk_rope_head_dim=16, qk_nope_head_dim=32,
                            v_head_dim=32)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=8, chunk=32)
        return dataclasses.replace(
            self, num_layers=self.group_size * min(2, self.num_groups),
            d_model=d_model, num_heads=heads, num_kv_heads=kv,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            head_dim=d_model // heads if self.head_dim is not None or True else None,
            moe=moe, mla=mla, ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            vision_tokens=min(self.vision_tokens, 32),
            sliding_window=min(self.sliding_window, 64),
            param_dtype=torch.float32)

    def num_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q_dim = self.num_heads * hd
        kv_dim = self.num_kv_heads * hd
        per_layer = {}
        # attention
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        else:
            attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        per_layer["attn"] = attn
        # ffn
        if self.ffn == "swiglu":
            ffn = 3 * d * dff
        elif self.ffn == "gelu":
            ffn = 2 * d * dff
        else:
            ffn = 0
        per_layer["ffn_dense"] = ffn
        # moe
        if self.moe is not None:
            edff = self.moe.expert_d_ff or dff
            e_ffn = 3 * d * edff
            moe_p = (self.moe.num_experts + self.moe.num_shared_experts) * e_ffn
            moe_p += d * self.moe.num_experts  # router
            if self.moe.dense_residual:
                moe_p += ffn
            per_layer["moe"] = moe_p
        # ssm / xlstm blocks
        if self.ssm is not None:
            di = self.ssm.expand * d
            dt_rank = self.ssm.dt_rank or max(1, d // 16)
            per_layer["mamba"] = (2 * d * di + di * self.ssm.conv_width
                                  + di * (dt_rank + 2 * self.ssm.state_dim)
                                  + dt_rank * di + di * self.ssm.state_dim + di * d)
        mlstm_d = 2 * d
        per_layer["mlstm"] = 2 * d * mlstm_d + 3 * mlstm_d * (mlstm_d // max(1, self.num_heads)) + mlstm_d * d
        per_layer["slstm"] = 4 * d * d + 4 * d * d + d * 4 * d // 4
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        for i in range(self.num_layers):
            kind = self.block_pattern[i % self.group_size]
            if kind == "attn":
                total += per_layer["attn"]
                if self.moe is not None and (i % self.moe.every_n_layers == 0):
                    total += per_layer["moe"]
                elif self.ffn != "none":
                    total += per_layer["ffn_dense"]
            elif kind == "mamba":
                total += per_layer["mamba"]
                if self.moe is not None and (i % self.moe.every_n_layers == 0):
                    total += per_layer["moe"]
            elif kind == "mlstm":
                total += per_layer["mlstm"]
            elif kind == "slstm":
                total += per_layer["slstm"]
        total += self.encoder_layers * (per_layer["attn"] + per_layer["ffn_dense"])
        if self.cross_attention:
            total += self.num_layers * per_layer["attn"]
        return total

    def num_active_params(self) -> int:
        """Active params per token (MoE top-k only)."""
        if self.moe is None:
            return self.num_params()
        edff = self.moe.expert_d_ff or self.d_ff
        e_ffn = 3 * self.d_model * edff
        inactive = (self.moe.num_experts - self.moe.top_k) * e_ffn
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if self.block_pattern[i % self.group_size] in ("attn", "mamba")
            and i % self.moe.every_n_layers == 0)
        return self.num_params() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
