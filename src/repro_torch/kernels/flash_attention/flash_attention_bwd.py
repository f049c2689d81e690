"""The gradient of flash attention (GQA, causal, sliding window) as
hand-written CUDA kernels for Hopper, on three routes.

The backward of ``ops.flash_attention`` on a CUDA tensor: dq, dk and dv
from q, k, v and the output's gradient, for queries whose positions start
at 0 against every key (training).  ``route`` picks the
route from the type, the head dim and the operands' alignment:

- ``tensor_core``: bf16, hd 64 or 128, every operand 16-byte aligned (TMA):
  wgmma and TMA, ``repro_torch/csrc/flash_attention_bwd_hopper.cu``;
- ``tf32x3``: float32, hd 64, every operand 16-byte aligned (Whisper's
  float32 encoder and cross-attention): wgmma on split float32 operands,
  three TF32 products for each,
  ``repro_torch/csrc/flash_attention_bwd_tf32.cu``;
- ``cuda_core``: everything else the kernels take (float32 at hd 32, 80 or
  128, hd 32 or 80, or a base TMA cannot read): fp32 on the CUDA cores,
  ``repro_torch/csrc/flash_attention_bwd.cu``.

Both split the gradient into a dq pass and a dk/dv pass and recompute the
rows' log-sum-exp and D = rowsum(P dP) rather than have the forward write
them; each source states its bound and design.  The kernels are compiled with ``nvcc`` at
first use (never at import) by ``repro_torch.kernels.nvcc`` and loaded
with ``ctypes``.

``launches`` counts every call that launched a route's kernels and
``route_launches`` the calls of each route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, HOPPER_HEAD_DIMS, MAX_BATCH, TF32_HEAD_DIMS)

SOURCE = nvcc.SOURCE_DIR / "flash_attention_bwd.cu"
HOPPER_SOURCE = nvcc.SOURCE_DIR / "flash_attention_bwd_hopper.cu"
TF32_SOURCE = nvcc.SOURCE_DIR / "flash_attention_bwd_tf32.cu"
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("tensor_core", "tf32x3", "cuda_core")
TC_QUERY_TILE = 128               # the wgmma dq kernels' query rows

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)
_lib = {}                         # {route: its entry point}, at first use


def route(dtype: torch.dtype, hd: int, *, aligned: bool = True) -> str:
    """The route a call takes: "tensor_core", "tf32x3" or "cuda_core".
    ``aligned``: every operand's base lies on 16 bytes (TMA's rule; the
    operands are contiguous, so their strides do).  Raises on a head dim or
    type no kernel takes."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernels take {HEAD_DIMS}")
    if dtype not in DTYPES:
        raise TypeError(f"the backward takes {DTYPES}, got {dtype}")
    if dtype == torch.bfloat16 and hd in HOPPER_HEAD_DIMS and aligned:
        return "tensor_core"
    if dtype == torch.float32 and hd in TF32_HEAD_DIMS and aligned:
        return "tf32x3"
    return "cuda_core"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (SOURCE, HOPPER_SOURCE or TF32_SOURCE) unless its
    library is already built; returns the library's path."""
    return nvcc.build(source)


def _load(which: str):
    if which not in _lib:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if which in ("tensor_core", "tf32x3"):
            tc = which == "tensor_core"
            lib = ctypes.CDLL(str(build(HOPPER_SOURCE if tc else TF32_SOURCE)))
            fn = lib.flash_attention_tc_bwd if tc else lib.flash_attention_tf32_bwd
            fn.argtypes = [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr]
        else:
            lib = ctypes.CDLL(str(build(SOURCE)))
            fn = lib.flash_attention_bwd
            fn.argtypes = [ptr] * 9 + [i32] * 9 + [ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        _lib[which] = fn
    return _lib[which]


def flash_attention_bwd_cuda(q, k, v, do, *, causal: bool = True,
                             window: Optional[int] = None):
    """Launch the route's backward on the current stream.  q, do (B, Sq,
    H, hd); k, v (B, Sk, KV, hd) with H a multiple of KV; all contiguous,
    of one type (float32 or bfloat16), on one card.  Returns (dq, dk, dv)
    in that type."""
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
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_BATCH}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q {q.dtype} "
                            f"on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, do, dq, dk, dv)
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    which = route(q.dtype, hd, aligned=aligned)
    if B == 0 or Sq == 0 or H == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    masks = (int(causal), 0 if window is None else int(window))
    fn = _load(which)
    if which in ("tensor_core", "tf32x3"):
        # the rows' lse and D, padded to whole query tiles
        pad = -(-Sq // TC_QUERY_TILE) * TC_QUERY_TILE
        stats = torch.empty((2, B, H, pad), dtype=torch.float32,
                            device=q.device)
        args = (*(t.data_ptr() for t in tensors), stats.data_ptr(), B, Sq,
                Sk, H, KV, hd, *masks, float(hd ** -0.5))
    else:
        stats = torch.empty((2, B, H, Sq), dtype=torch.float32,
                            device=q.device)
        args = (*(t.data_ptr() for t in tensors), stats[0].data_ptr(),
                stats[1].data_ptr(), int(q.dtype == torch.bfloat16), B, Sq,
                Sk, H, KV, hd, *masks, float(hd ** -0.5), int(aligned))
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed on the "
                           f"{which} route: error {err}")
    launches += 1
    route_launches[which] += 1
    return dq, dk, dv
