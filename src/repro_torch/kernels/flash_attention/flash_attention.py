"""Flash attention (GQA, causal, sliding window, per-row valid length) as
a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``; the source, with its bound and design, is
``repro_torch/csrc/flash_attention.cu``.  The kernel is compiled with
``nvcc`` at first use (never at import) by ``repro_torch.kernels.nvcc``
and loaded with ``ctypes``.

``launches`` counts every launch of the kernel: a run can show that its
path went through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.SOURCE_DIR / "flash_attention.cu"
HEAD_DIMS = (32, 64, 80, 128)
# (q, k/v) types the kernel takes; the output is in q's type
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))

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
        fn = lib.flash_attention_fwd
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([ptr] * 5 + [i32] * 9 + [i64] * 9
                       + [i32, i32, i64, ctypes.c_float, i32, i32, i32, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte loads: the base and every stride land on 16 bytes."""
    per16 = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:-1]))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         kv_len: Union[None, int, torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the kernel on the current stream.  q (B, Sq, H, hd); k, v
    (B, Sk, KV, hd) with H a multiple of KV; any strides with the last
    dimension contiguous.  ``kv_len``: None (all Sk keys), an int, or a
    (B,) integer tensor on the card (per-row valid lengths, read there).
    Returns (B, Sq, H, hd) in q's type."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q is (B, Sq, H, hd); k and v are (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"pair: same B and hd, H a multiple of KV")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if Sk == 0:
        raise ValueError("k and v hold no keys")
    if (q.dtype, k.dtype) not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel "
                        f"takes (q, k/v) in {DTYPES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")

    kv_ptr, kv_all = None, Sk
    if isinstance(kv_len, torch.Tensor):
        if kv_len.shape != (B,) or kv_len.device != q.device:
            raise ValueError(f"kv_len is a (B,) tensor on {q.device}, got "
                             f"{tuple(kv_len.shape)} on {kv_len.device}")
        kv_len = kv_len.to(torch.int32).contiguous()
        kv_ptr = kv_len.data_ptr()
    elif kv_len is not None:
        kv_all = min(int(kv_len), Sk)

    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out
    fn = _load().flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kv_ptr, kv_all, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), 0 if window is None else int(window),
                 int(q_offset), float(hd ** -0.5), int(_vec_ok(q)),
                 int(_vec_ok(k)), int(_vec_ok(v)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return out
