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

The forward and the backward are each one operator of their own
(``repro_torch::flash_attention``, ``repro_torch::flash_attention_bwd``),
so that an op recorder sees a call as one site (the cost model counts the
kernel's work there, not the plain version's steps) and a fake tensor
passes through with its shape.  A ``DTensor`` call runs each rank's shard
through ``local_map`` (:func:`repro_torch.sharding.context.local_dims`):
the batch over the batch axes and the heads over ``model`` (where ``model``
divides both head counts), as the rules shard them.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from repro_torch.kernels.flash_attention import ref as ref_lib
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd_cuda)
from repro_torch.sharding.context import is_dtensor, local_dims

HEADS = "b.m."          # (B, S, heads, hd): the batch and the heads sharded


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], q_offset: int,
           kv_len: Optional[torch.Tensor],
           kv_len_int: Optional[int]) -> torch.Tensor:
    """The forward on plain tensors: ``kv_len`` (a (B,) tensor) or
    ``kv_len_int``, or neither."""
    kv = kv_len if kv_len is not None else kv_len_int
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv)
    if q.device.type == "cpu":
        return ref_lib.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           kv_len=kv)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


@_flash.register_fake
def _flash_fake(q, k, v, causal, window, q_offset, kv_len, kv_len_int):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, causal: bool, window: Optional[int]
               ) -> List[torch.Tensor]:
    """(dq, dk, dv) from contiguous q, k, v and do of one type."""
    if q.device.type == "cuda":
        return list(flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                             window=window))
    lse = ref_lib.flash_attention_lse_ref(q, k, causal=causal, window=window)
    return list(ref_lib.flash_attention_bwd_ref(q, k, v, do, lse,
                                                causal=causal, window=window))


@_flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, do, causal, window):
    return [torch.empty_like(t) for t in (q, k, v)]


def _forward(q, k, v, *, causal, window, q_offset=0, kv_len=None):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    tensor_len = kv_len if isinstance(kv_len, torch.Tensor) else None
    int_len = None if tensor_len is not None or kv_len is None else int(kv_len)
    if is_dtensor(q):
        return local_dims(
            lambda q, k, v, n: _flash(q, k, v, causal, window, q_offset, n,
                                      int_len),
            (q, HEADS), (k, HEADS), (v, HEADS), (tensor_len, "b"), out=HEADS)
    return _flash(q, k, v, causal, window, q_offset, tensor_len, int_len)


def _backward(q, k, v, do, *, causal, window):
    if is_dtensor(q):
        return local_dims(
            lambda q, k, v, do: tuple(_flash_bwd(q, k, v, do, causal, window)),
            (q, HEADS), (k, HEADS), (v, HEADS), (do, HEADS),
            out=(HEADS, HEADS, HEADS))
    return tuple(_flash_bwd(q, k, v, do, causal, window))


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
        dq, dk, dv = _backward(q, k, v, do, causal=causal, window=window)
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
