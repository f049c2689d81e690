"""Attention in the reference's public layout — the kernel for a CUDA
tensor, the plain version for a CPU tensor.

The reference's wrapper (``repro/kernels/flash_attention/ops.py``) padded
hd to 128 lanes, padded S to the block and transposed to (B, H, S, hd) for
the TPU.  The CUDA kernel reads the (B, S, H, hd) layout through strides
and masks ragged edges itself, so nothing is padded or copied here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import ref as ref_lib
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Union[None, int, torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``q_offset`` is the absolute position of q[:, 0] (causal and
    window masks); ``kv_len`` the valid length of k/v, an int or a (B,)
    tensor."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return ref_lib.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           kv_len=kv_len)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
