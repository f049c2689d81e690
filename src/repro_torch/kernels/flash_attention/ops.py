"""Attention in the reference's public layout — the kernel for a CUDA
tensor, the plain version for a CPU tensor — and its gradient.

The reference's wrapper (``repro/kernels/flash_attention/ops.py``) padded
hd to 128 lanes, padded S to the block and transposed to (B, H, S, hd) for
the TPU.  The CUDA kernel reads the (B, S, H, hd) layout through strides
and masks ragged edges itself, so nothing is padded or copied here.

Where a gradient is asked for (grad mode on and q, k or v requiring one),
the call goes through ``FlashAttention``, an autograd function whose
forward is the same routes and whose backward is the backward kernel
(``flash_attention_bwd``) on the card and ``ref.flash_attention_bwd_ref``
on the CPU.  Otherwise it launches what serving always launched: the
forward alone, which keeps no statistics.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import ref as ref_lib
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd_cuda)


def _forward(q, k, v, *, causal, window, q_offset=0, kv_len=None):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return ref_lib.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           kv_len=kv_len)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


class FlashAttention(torch.autograd.Function):
    """Attention over positions from 0 against every key, with the
    backward kernel as its gradient on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o = _forward(q, k, v, causal=causal, window=window)
        # the backward recomputes what it needs of the forward from these
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window = ctx.masks
        q, k, v, do = (t.contiguous() for t in (q, k, v, do.to(q.dtype)))
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                                  window=window)
        else:
            lse = ref_lib.flash_attention_lse_ref(q, k, causal=causal,
                                                  window=window)
            dq, dk, dv = ref_lib.flash_attention_bwd_ref(
                q, k, v, do, lse, causal=causal, window=window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Union[None, int, torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``q_offset`` is the absolute position of q[:, 0] (causal and
    window masks); ``kv_len`` the valid length of k/v, an int or a (B,)
    tensor.  Differentiable for ``q_offset`` 0 and no ``kv_len``, as
    training calls it; asking for a gradient otherwise raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset != 0 or kv_len is not None:
            raise NotImplementedError(
                f"flash_attention's gradient takes q_offset 0 and no kv_len "
                f"(training), got q_offset={q_offset}, kv_len={kv_len}")
        if q.device.type not in ("cuda", "cpu"):
            raise ValueError(f"flash_attention runs on cuda or cpu, not "
                             f"{q.device}")
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    kv_len=kv_len)
