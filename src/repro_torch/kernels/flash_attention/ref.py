"""The plain PyTorch versions of the flash-attention kernels.

``flash_attention_ref`` is a port of
``repro/kernels/flash_attention/ref.py::flash_attention_ref`` (GQA, causal,
optional sliding window), fp32 math throughout.  ``kv_len`` takes the place
of the reference's ``seq_k`` and may also be a (B,) tensor of per-row
valid lengths (decode against a cache).

``flash_attention_split_k_ref`` computes the same function the way the
split-K decode kernel does: the cache cut into chunks of ``chunk`` keys
(the wrapper's ``split_k_chunk``), one partial (m, l, acc) per chunk, then
the merge.

``flash_attention_bwd_ref`` is the plain gradient that the backward kernel
computes (dq, dk, dv from q, k, v, the output's gradient and the rows'
log-sum-exp, ``flash_attention_lse_ref``), for queries whose positions
start at 0 against every key, as training calls it."""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def _scores(q, k, *, causal: bool, window: Optional[int], q_offset: int = 0,
            kv_len: Union[None, int, torch.Tensor] = None):
    """The scaled scores (B, H, Sq, Sk) in fp32 and the mask of the pairs
    that count (broadcast against them)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KV, dim=2)
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
    return s, mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        kv_len: Union[None, int, torch.Tensor] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype."""
    s, mask = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                      kv_len=kv_len)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    vr = v.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return o.to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores over the keys it sees,
    (B, H, Sq) fp32."""
    s, mask = _scores(q, k, causal=causal, window=window)
    return torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)


def flash_attention_bwd_ref(q, k, v, do, lse, *, causal: bool = True,
                            window: Optional[int] = None):
    """The gradient of ``flash_attention_ref`` (``q_offset`` 0, every key
    valid) at cotangent ``do``, from the log-sum-exp ``lse`` (B, H, Sq):
    P = exp(s - lse), dP = do v^T, D = rowsum(P dP), dS = P (dP - D), dq =
    scale dS k, dk = scale dS^T q and dv = P^T do, summed over the query
    heads of each KV head; fp32 math, each result in its input's dtype.
    D is softmax's own sum, not FlashAttention-2's rowsum(do o) from the
    forward's output, which in bf16 swamps dS where a row's attention
    spreads over many alike keys."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    s, mask = _scores(q, k, causal=causal, window=window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    do32 = do.float()
    vr = v.repeat_interleave(rep, dim=2).float()
    kr = k.repeat_interleave(rep, dim=2).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, vr)
    delta = (p * dp).sum(-1)                                  # (B, H, Sq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dk = dk.reshape(B, Sk, KV, rep, hd).sum(3)
    dv = dv.reshape(B, Sk, KV, rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _valid_lengths(kv_len, B: int, Sk: int, device) -> torch.Tensor:
    """min(Sk, kv_len) per batch row, as a (B,) int64 tensor."""
    if kv_len is None:
        return torch.full((B,), Sk, dtype=torch.int64, device=device)
    kv = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return kv.expand(B).clamp(max=Sk)


def split_k_ranges(kv_valid: torch.Tensor, Sq: int, Sk: int, chunk: int, *,
                   causal: bool, window: Optional[int], q_offset: int):
    """[kbeg, kend) of every chunk, (B, n_chunks) each, for the valid
    lengths ``kv_valid`` (B,): the chunk's keys that some query of the
    call can see.  kend <= kbeg marks a chunk whose partial is empty."""
    c0 = torch.arange(-(-Sk // chunk), device=kv_valid.device) * chunk
    kbeg = c0.expand(kv_valid.shape[0], -1)
    kend = torch.minimum(c0 + chunk, kv_valid[:, None])
    if causal:
        kend = kend.clamp(max=q_offset + Sq)
    if window is not None:
        kbeg = kbeg.clamp(min=q_offset - window + 1)
    return kbeg, kend


def split_k_partials(q, k, v, *, chunk: int, causal: bool = True,
                     window: Optional[int] = None, q_offset: int = 0,
                     kv_len: Union[None, int, torch.Tensor] = None):
    """The split-K kernel's first pass: for each chunk c, batch row b, head
    h and query i, over the chunk's keys [kbeg, kend) with the reference's
    masks (-1e30), m = max s, l = sum exp(s - m), acc = sum exp(s - m) v.
    Returns m, l (B, n_chunks, H, Sq) and acc (B, n_chunks, H, Sq, hd), fp32;
    an empty chunk has m = -1e30, l = 0 and acc = 0."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kr = k.repeat_interleave(rep, dim=2).float()
    vr = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    kv_valid = _valid_lengths(kv_len, B, Sk, q.device)
    mask = mask[None, None] & (k_pos < kv_valid[:, None])[:, None, None]
    s = torch.where(mask, s, NEG_INF)                  # (B, H, Sq, Sk)

    kbeg, kend = split_k_ranges(kv_valid, Sq, Sk, chunk, causal=causal,
                                window=window, q_offset=q_offset)
    in_chunk = ((k_pos >= kbeg[..., None])
                & (k_pos < kend[..., None]))           # (B, C, Sk)
    sel = in_chunk[:, :, None, None]                   # (B, C, 1, 1, Sk)
    x = torch.where(sel, s[:, None], float("-inf"))
    empty = ~in_chunk.any(-1)[:, :, None, None]        # (B, C, 1, 1)
    m = torch.where(empty, NEG_INF, x.amax(-1))
    p = torch.where(sel, torch.exp(x - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bchqk,bkhd->bchqd", p, vr)
    return m, l, acc


def split_k_merge(m, l, acc):
    """The merge kernel: skip empty partials (l = 0), then o = sum_c
    exp(m_c - M) acc_c / max(sum_c exp(m_c - M) l_c, 1e-30) over chunks
    (dim 1).  Returns (B, H, Sq, hd), fp32."""
    keep = l > 0
    M = torch.where(keep, m, float("-inf")).amax(1, keepdim=True)
    w = torch.where(keep, torch.exp(m - M), 0.0)
    den = (w * l).sum(1)
    num = torch.einsum("bchq,bchqd->bhqd", w, acc)
    return num / den.clamp(min=1e-30)[..., None]


def flash_attention_split_k_ref(q, k, v, *, causal: bool = True,
                                window: Optional[int] = None,
                                q_offset: int = 0,
                                kv_len: Union[None, int, torch.Tensor] = None,
                                chunk: int):
    """``flash_attention_ref`` computed as the split-K decode kernel
    computes it, in chunks of ``chunk`` keys.  q: (B, Sq, H, hd); k/v: (B,
    Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    m, l, acc = split_k_partials(q, k, v, chunk=chunk, causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_len=kv_len)
    return split_k_merge(m, l, acc).permute(0, 2, 1, 3).to(q.dtype)
