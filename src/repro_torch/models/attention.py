"""GQA self-attention (RoPE, optional qkv bias, sliding window) with a
decode KV cache, and DeepSeek-V2's multi-head latent attention (MLA) with
its latent cache: the port of ``repro/models/attention.py``.

On CUDA tensors every GQA attention call goes through the hand-written
flash-attention kernel (``repro_torch.kernels.flash_attention``); on CPU
tensors through ``blockwise_attention``, the plain port of the reference's
memory-bounded attention, which is also the numerical oracle the reference
names for its kernel.  MLA calls ``blockwise_attention`` on every device,
as the reference does: its heads (qk 192, v 128, 128 query heads on a
latent) are no shape the kernel takes.

Cross-attention (Whisper's decoder over the encoder's output) computes its
K/V from ``kv_source`` without RoPE; prefill stores them in the layer's
``{"ck", "cv"}`` cache (bf16) and decode attends over them there.  The
int8 KV cache (``gqa_cache_init(quantized=True)``) stores int8 values and
one bf16 scale per (position, KV head) and is dequantized before attention,
as the reference's, so the kernel still sees the model's type.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import HEADS
from repro_torch.models import modules as nn
from repro_torch.sharding.context import is_dtensor, local_dims

NEG_INF = -1e30
QUANT_MAX = 127.0                 # int8 cache: symmetric, [-127, 127]

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
    ``DTensor``s run shard by shard: the batch and the heads.
    """
    if is_dtensor(q):
        rows = kv_len if isinstance(kv_len, torch.Tensor) else None
        return local_dims(
            lambda q, k, v, n: blockwise_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len if n is None else n, q_block=q_block),
            (q, HEADS), (k, HEADS), (v, HEADS), (rows, "b"), out=HEADS)
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
    tensors.  A ``DTensor`` (the dry run's mesh, which stands for the
    card's) takes the kernel's operator on every device."""
    if q.device.type == "cuda" or is_dtensor(q):
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, q_block=q_block)


# ------------------------------------------------------------------ GQA --
def gqa_init(key, cfg: ArchConfig, *, cross: bool = False):
    """The four projections; ``cross`` names the use (cross-attention) and
    changes nothing, as in the reference."""
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
    reference's).  ``quantized=True`` stores int8 values and one bf16 scale
    per (position, KV head)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x):
    """x: (B, S, KV, hd) -> (int8 values, bf16 per-(position, head) scale).
    The values are rounded (half to even, as ``jnp.round``) against the
    float32 scale, which is rounded to bf16 only when it is returned."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / QUANT_MAX).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-QUANT_MAX, QUANT_MAX)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None].float()).to(dtype)


def _write_at(buf, val, pos):
    """Write val (B, L, ...) into buf (B, S, ...) at seq position ``pos`` —
    an int, or a (B,) tensor for per-slot positions — in place.  Each
    position is clamped into [0, S - L] so the write fits, as
    ``lax.dynamic_update_slice`` clamps it: a continuous-batching server
    advances an empty slot's position past the cache, and the reference
    then writes that row's last position."""
    val = val.to(buf.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.clamp(0, buf.shape[1] - val.shape[1])
        idx = pos[:, None] + torch.arange(val.shape[1], device=buf.device)
        buf[torch.arange(buf.shape[0], device=buf.device)[:, None], idx] = val
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
    its serving step, so no caller keeps the old one.  ``kv_source``: the
    encoder's output for cross-attention (None at decode, where the cross
    K/V come from the cache that prefill filled)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = nn.dense_apply(nn.tp_weight(p["wq"], None, "model"),
                       x).reshape(B, S, H, hd)
    cross = cross or kv_source is not None
    cached_cross = (cross and mode == "decode" and cache is not None
                    and "ck" in cache)
    if not cached_cross:           # cross K/V are never recomputed at decode
        src = x if kv_source is None else kv_source
        k = nn.dense_apply(nn.tp_weight(p["wk"], None, "model"),
                           src).reshape(B, src.shape[1], KV, hd)
        v = nn.dense_apply(nn.tp_weight(p["wv"], None, "model"),
                           src).reshape(B, src.shape[1], KV, hd)
    if cfg.pos_emb == "rope" and not cross:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)

    if cached_cross:
        # the encoder's K/V, computed once at prefill
        out = _attend(q, cache["ck"].to(q.dtype), cache["cv"].to(q.dtype),
                      causal=False, window=None, q_block=8)
    elif cross:
        out = _attend(q, k, v, causal=False, window=None,
                      q_block=min(1024, max(8, S)))
        if mode == "prefill" and cache is not None and "ck" in cache:
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
    elif mode == "decode":
        # write this step's k/v at cache_pos, attend over the valid prefix
        quantized = "k_scale" in cache
        if quantized:
            for name, val in (("k", k), ("v", v)):
                vq, vs = _quantize_kv(val)
                _write_at(cache[name], vq, cache_pos)
                _write_at(cache[name + "_scale"], vs, cache_pos)
        else:
            _write_at(cache["k"], k, cache_pos)
            _write_at(cache["v"], v, cache_pos)
        kv_len = cache_pos + 1

        def read(name, start=None, length=None):
            buf, sc = cache[name], cache.get(name + "_scale")
            if start is not None:
                buf = _slice_at(buf, start, length)
                sc = None if sc is None else _slice_at(sc, start, length)
            return buf if sc is None else _dequantize_kv(buf, sc, k.dtype)

        if window is not None:
            # only read the last `window` positions (sliding window decode)
            win = min(window, cache["k"].shape[1])     # short caches
            if isinstance(kv_len, torch.Tensor):
                start = (kv_len - win).clamp(min=0)
                kv_len = kv_len.clamp(max=win)
            else:
                start, kv_len = max(kv_len - win, 0), min(kv_len, win)
            out = _attend(q, read("k", start, win), read("v", start, win),
                          causal=False, window=None, kv_len=kv_len, q_block=8)
        else:
            out = _attend(q, read("k"), read("v"), causal=False,
                          window=None, kv_len=kv_len, q_block=8)
    else:  # train / prefill: full causal; encoder: bidirectional
        out = _attend(q, k, v, causal=(mode != "encode"), window=window,
                      q_block=min(1024, max(8, S)))
        if mode == "prefill" and cache is not None:
            if "k_scale" in cache:
                for name, val in (("k", k), ("v", v)):
                    vq, vs = _quantize_kv(val)
                    cache[name][:, :S] = vq
                    cache[name + "_scale"][:, :S] = vs
            else:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
    y = nn.dense_apply(nn.tp_weight(p["wo"], "model", None),
                       out.reshape(B, S, H * hd))
    return y, cache


# ------------------------------------------------------------------ MLA --
def mla_init(key, cfg: ArchConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    r = random.split(key, 6)
    dt = cfg.param_dtype
    dev = key.device
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": nn.dense_init(r[0], d, m.q_lora_rank, dtype=dt),
        "q_norm": nn.norm_init("rmsnorm", m.q_lora_rank, dt, device=dev),
        "wq_b": nn.dense_init(r[1], m.q_lora_rank, H * qk_dim, dtype=dt),
        "wkv_a": nn.dense_init(r[2], d, m.kv_lora_rank + m.qk_rope_head_dim,
                               dtype=dt),
        "kv_norm": nn.norm_init("rmsnorm", m.kv_lora_rank, dt, device=dev),
        "wkv_b": nn.dense_init(r[3], m.kv_lora_rank,
                               H * (m.qk_nope_head_dim + m.v_head_dim),
                               dtype=dt),
        "wo": nn.dense_init(r[4], H * m.v_head_dim, d, dtype=dt),
    }


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, device):
    """The latent cache: c_kv and the shared RoPE key, bf16."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_qkr(p, x, cfg: ArchConfig, positions):
    """The queries (no-RoPE and RoPE parts), the latent and the RoPE key."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q = nn.dense_apply(p["wq_b"], nn.norm_apply(
        "rmsnorm", p["q_norm"], nn.dense_apply(p["wq_a"], x)))
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = nn.apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = nn.dense_apply(p["wkv_a"], x)
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = nn.norm_apply("rmsnorm", p["kv_norm"], c_kv)
    k_rope = nn.apply_rope(k_rope[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, x, *, cfg: ArchConfig, mode: str, positions, cache=None,
              cache_pos=None, absorb: bool = True, **_):
    """Returns (y, new_cache).  Prefill materialises per-head K/V and
    attends causally; decode attends in the latent space (``absorb``: W_uk
    folded into the queries, W_uv applied after), in float32 over the whole
    cache with a ``< kv_len`` mask, so the cache stays kv_lora + rope wide.
    The cache is written in place, as ``gqa_apply``'s.  Decode takes one
    position for every row (an int); per-slot positions raise."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, x, cfg, positions)
    wkv_b = p["wkv_b"]["w"].reshape(m.kv_lora_rank, H,
                                    m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim].float()        # (L, H, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:].float()        # (L, H, v)

    if mode == "decode":
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
            raise NotImplementedError(
                "MLA takes one decode position for every row, as the "
                "reference's mla_apply (src/repro/models/attention.py:311-314)"
                "; per-slot positions (serving/scheduler.py) are not "
                "supported in either package")
        pos = int(cache_pos)
        c_cache = _write_at(cache["c_kv"], c_kv, pos)
        r_cache = _write_at(cache["k_rope"], k_rope, pos)
        kv_len = pos + 1
        if absorb:
            q_lat = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_uk)
            scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
            c32, r32 = c_cache.float(), r_cache.float()
            s = (torch.einsum("bshl,btl->bhst", q_lat, c32)
                 + torch.einsum("bshr,btr->bhst", q_rope.float(), r32)) * scale
            mask = torch.arange(c_cache.shape[1], device=x.device) < kv_len
            s = torch.where(mask, s, NEG_INF)
            pr = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btl->bshl", pr, c32)    # (B,S,H,L)
            out = torch.einsum("bshl,lhv->bshv", o_lat, w_uv)
        else:
            c32 = c_cache.float()
            k_nope = torch.einsum("btl,lhn->bthn", c32, w_uk)
            v_full = torch.einsum("btl,lhv->bthv", c32, w_uv)
            k_full = torch.cat([k_nope, r_cache[:, :, None, :].float().expand(
                -1, -1, H, -1)], -1)
            q_full = torch.cat([q_nope, q_rope], -1)
            out = blockwise_attention(q_full, k_full.to(q_full.dtype),
                                      v_full.to(q_full.dtype), causal=False,
                                      window=None, kv_len=kv_len, q_block=8)
    else:
        # train / prefill: per-head K/V materialised, as the paper states it
        c32 = c_kv.float()
        k_nope = torch.einsum("btl,lhn->bthn", c32, w_uk).to(x.dtype)
        v_full = torch.einsum("btl,lhv->bthv", c32, w_uv).to(x.dtype)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(-1, -1, H, -1)],
                           -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        out = blockwise_attention(q_full, k_full, v_full, causal=True,
                                  window=None, q_block=min(1024, max(8, S)))
        if mode == "prefill" and cache is not None:
            cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
    y = nn.dense_apply(p["wo"], out.reshape(B, S, H * m.v_head_dim).to(x.dtype))
    return y, cache
