"""The gradient of flash attention (GQA, causal, sliding window) as a
hand-written CUDA kernel for Hopper.

The backward of ``ops.flash_attention`` on a CUDA tensor: dq, dk and dv
from q, k, v, the forward's output and its gradient, for queries whose
positions start at 0 against every key (training).  The source, with its
bound and design, is ``repro_torch/csrc/flash_attention_bwd.cu``: two
passes on the CUDA cores, which recompute the rows' log-sum-exp rather
than have the forward write it.  The kernel is compiled with ``nvcc`` at
first use (never at import) by ``repro_torch.kernels.nvcc`` and loaded
with ``ctypes``.

``launches`` counts every call that launched the kernel's passes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention.flash_attention import (HEAD_DIMS,
                                                                 MAX_BATCH)

SOURCE = nvcc.SOURCE_DIR / "flash_attention_bwd.cu"
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_lib = None


def build() -> Path:
    """Compile the kernel unless this source's library is already built;
    returns the library's path."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_bwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 9 + [ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_bwd_cuda(q, k, v, o, do, *, causal: bool = True,
                             window: Optional[int] = None):
    """Launch the backward on the current stream.  q, o, do (B, Sq, H, hd);
    k, v (B, Sk, KV, hd) with H a multiple of KV; all contiguous, of one
    type (float32 or bfloat16), on one card.  Returns (dq, dk, dv) in that
    type."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda takes CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q is (B, Sq, H, hd); k and v are (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"pair: same B and hd, H a multiple of KV")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the backward takes {DTYPES}, got {q.dtype}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_BATCH}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q {q.dtype} "
                            f"on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0 or H == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    vec = all(t.data_ptr() % 16 == 0 for t in tensors)
    with torch.cuda.device(q.device):
        err = _load().flash_attention_bwd(
            *(t.data_ptr() for t in tensors), stats[0].data_ptr(),
            stats[1].data_ptr(), int(q.dtype == torch.bfloat16), B, Sq, Sk,
            H, KV, hd, int(causal), 0 if window is None else int(window),
            float(hd ** -0.5), int(vec), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: error {err}")
    launches += 1
    return dq, dk, dv
