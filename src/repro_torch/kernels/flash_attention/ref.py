"""The plain PyTorch version of the flash-attention kernel: a port of
``repro/kernels/flash_attention/ref.py::flash_attention_ref`` (GQA, causal,
optional sliding window), fp32 math throughout.  ``kv_len`` takes the place
of the reference's ``seq_k`` and may also be a (B,) tensor of per-row
valid lengths (decode against a cache)."""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        kv_len: Union[None, int, torch.Tensor] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask = mask[None, None]                            # (1, 1, Sq, Sk)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 1:                          # (B,) per-row lengths
            mask = mask & (k_pos[None, :] < kv_len[:, None])[:, None, None]
        else:
            mask = mask & (k_pos < kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return o.to(q.dtype)
