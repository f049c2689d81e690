"""GQA self-attention (RoPE, optional qkv bias, sliding window) with a
decode KV cache: the port of ``repro/models/attention.py``.

On CUDA tensors every attention call goes through the hand-written
flash-attention kernel (``repro_torch.kernels.flash_attention``); on CPU
tensors through ``blockwise_attention``, the plain port of the reference's
memory-bounded attention, which is also the numerical oracle the reference
names for its kernel.  MLA, cross-attention and the int8 KV cache are not
ported yet (ROADMAP queue 1, item 12) and raise.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import modules as nn

NEG_INF = -1e30
_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 12)"

Length = Union[None, int, torch.Tensor]


# ----------------------------------------------------------------- core --
def blockwise_attention(q, k, v, *, causal: bool, window: Optional[int],
                        q_offset: int = 0, kv_len: Length = None,
                        q_block: int = 1024):
    """Memory-bounded attention, in plain PyTorch.

    q: (B, Sq, H, hd);  k/v: (B, Sk, KV, hd) — GQA by head grouping.
    ``q_offset``: absolute position of q[0] (decode / chunked prefill).
    ``window``: sliding-window size (None = full).
    ``kv_len``: optional valid length of k/v, an int or a (B,) tensor.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    kT = k.permute(0, 2, 3, 1).float()                 # (B, KV, hd, Sk)
    vT = v.permute(0, 2, 1, 3).float()                 # (B, KV, Sk, hd)
    kv_pos = torch.arange(Sk, device=q.device)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)

    nb = max(1, -(-Sq // q_block))
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nb * q_block - Sq))
    outs = []
    for i in range(nb):
        qb = qp[:, i * q_block:(i + 1) * q_block]       # (B, q_block, H, hd)
        q_pos = q_offset + i * q_block + torch.arange(q_block, device=q.device)
        qg = qb.reshape(B, q_block, KV, rep, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bgrqd,bgdk->bgrqk", qg.float(), kT) * scale
        mask = torch.ones((q_block, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        mask = mask[None, None, None]
        if kv_len is not None:
            if kv_len.dim() == 1:                       # (B,) per-slot lengths
                mask = mask & (kv_pos[None, :] <
                               kv_len[:, None])[:, None, None, None]
            else:
                mask = mask & (kv_pos < kv_len)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bgkd->bgrqd", p, vT)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_block, H,
                                                     v.shape[-1]))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def _attend(q, k, v, *, causal: bool, window: Optional[int],
            kv_len: Length = None, q_block: int):
    """The kernel for CUDA tensors, the plain blockwise version for CPU
    tensors."""
    if q.device.type == "cuda":
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, q_block=q_block)


# ------------------------------------------------------------------ GQA --
def gqa_init(key, cfg: ArchConfig, *, cross: bool = False):
    if cross:
        raise NotImplementedError(f"cross-attention {_NOT_PORTED}")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    r = random.split(key, 4)
    dt = cfg.param_dtype
    return {"wq": nn.dense_init(r[0], d, H * hd, bias=cfg.qkv_bias, dtype=dt),
            "wk": nn.dense_init(r[1], d, KV * hd, bias=cfg.qkv_bias, dtype=dt),
            "wv": nn.dense_init(r[2], d, KV * hd, bias=cfg.qkv_bias, dtype=dt),
            "wo": nn.dense_init(r[3], H * hd, d, dtype=dt)}


def gqa_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, quantized: bool = False, *, device):
    """KV cache, bf16 by default whatever the model's dtype (as the
    reference's)."""
    if quantized:
        raise NotImplementedError(f"the int8 KV cache {_NOT_PORTED}")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_at(buf, val, pos):
    """Write val (B, 1, ...) into buf (B, S, ...) at seq position ``pos`` —
    an int, or a (B,) tensor for per-slot positions — in place."""
    val = val.to(buf.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        buf[torch.arange(buf.shape[0], device=buf.device), pos] = val[:, 0]
    else:
        pos = min(max(int(pos), 0), buf.shape[1] - val.shape[1])
        buf[:, pos:pos + val.shape[1]] = val
    return buf


def _slice_at(buf, start, length: int):
    """Read a (B, length, ...) window starting at ``start`` (an int: a view;
    or a (B,) tensor of per-slot starts: a gather).  Starts are clamped so
    the window fits, as ``lax.dynamic_slice`` clamps them."""
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        start = start.clamp(0, buf.shape[1] - length)
        idx = start[:, None] + torch.arange(length, device=buf.device)
        return buf[torch.arange(buf.shape[0], device=buf.device)[:, None], idx]
    start = min(max(int(start), 0), buf.shape[1] - length)
    return buf.narrow(1, start, length)


def gqa_apply(p, x, *, cfg: ArchConfig, mode: str, positions,
              cache=None, cache_pos=None, kv_source=None,
              window: Optional[int] = None, cross: bool = False):
    """Returns (y, new_cache).  Prefill and decode write the new K/V into
    ``cache`` in place and return it: the reference donates the cache to
    its serving step, so no caller keeps the old one."""
    if cross or kv_source is not None:
        raise NotImplementedError(f"cross-attention {_NOT_PORTED}")
    if cache is not None and "k_scale" in cache:
        raise NotImplementedError(f"the int8 KV cache {_NOT_PORTED}")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = nn.dense_apply(p["wq"], x).reshape(B, S, H, hd)
    k = nn.dense_apply(p["wk"], x).reshape(B, S, KV, hd)
    v = nn.dense_apply(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.pos_emb == "rope":
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        # write this step's k/v at cache_pos, attend over the valid prefix
        _write_at(cache["k"], k, cache_pos)
        _write_at(cache["v"], v, cache_pos)
        kv_len = cache_pos + 1
        if window is not None:
            # only read the last `window` positions (sliding window decode)
            win = min(window, cache["k"].shape[1])     # short caches
            if isinstance(kv_len, torch.Tensor):
                start = (kv_len - win).clamp(min=0)
                kv_len = kv_len.clamp(max=win)
            else:
                start, kv_len = max(kv_len - win, 0), min(kv_len, win)
            out = _attend(q, _slice_at(cache["k"], start, win),
                          _slice_at(cache["v"], start, win), causal=False,
                          window=None, kv_len=kv_len, q_block=8)
        else:
            out = _attend(q, cache["k"], cache["v"], causal=False,
                          window=None, kv_len=kv_len, q_block=8)
    else:  # train / prefill: full causal; encoder: bidirectional
        out = _attend(q, k, v, causal=(mode != "encode"), window=window,
                      q_block=min(1024, max(8, S)))
        if mode == "prefill" and cache is not None:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    y = nn.dense_apply(p["wo"], out.reshape(B, S, H * hd))
    return y, cache
