"""Flash attention (GQA, causal, sliding window, per-row valid length) as
hand-written CUDA kernels for Hopper, on four routes.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``.  ``route`` picks the route from the types, the
head dim and the number of queries:

- ``tensor_core``: bf16 q and K/V, hd 64 or 128, more than 16 queries,
  operands TMA can read (prefill): wgmma and TMA,
  ``repro_torch/csrc/flash_attention_hopper.cu``;
- ``split_k``: bf16 q and K/V, hd 64 or 128, at most 16 queries (decode):
  the cache split into chunks over the grid, then a merge, in the same
  source;
- ``tf32x3``: float32 q and K/V, hd 64, more than 16 queries, operands TMA
  can read (Whisper's float32 encoder and cross-attention at prefill):
  wgmma on split float32 operands, three TF32 products for each,
  ``repro_torch/csrc/flash_attention_tf32.cu``;
- ``cuda_core``: everything else the kernels take (float32 at hd 32, 80 or
  128, float32 decode, float32 q on a bf16 cache, hd 32 or 80, or strides
  TMA cannot read): fp32 on the CUDA cores,
  ``repro_torch/csrc/flash_attention.cu``.

Each source states its bound and design.  The kernels are compiled with
``nvcc`` at first use (never at import) by ``repro_torch.kernels.nvcc`` and
loaded with ``ctypes``.  ``launches`` counts every call that launched its
kernels and ``route_launches`` the calls of each route, so a run can show
which code served it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.SOURCE_DIR / "flash_attention.cu"
HOPPER_SOURCE = nvcc.SOURCE_DIR / "flash_attention_hopper.cu"
TF32_SOURCE = nvcc.SOURCE_DIR / "flash_attention_tf32.cu"
HEAD_DIMS = (32, 64, 80, 128)
HOPPER_HEAD_DIMS = (64, 128)
TF32_HEAD_DIMS = (64,)
SPLIT_K_MAX_QUERIES = 16
# (q, k/v) types the kernels take; the output is in q's type
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))
ROUTES = ("tensor_core", "split_k", "tf32x3", "cuda_core")
MAX_BATCH = 65535                 # a grid dimension
# The split-K decode's chunks: whole tiles of 64 keys, at least 3 of them (a
# block's fixed costs, its first load's latency and the combine of its
# warps, then weigh less: chunks of 192 keys beat 64 and 128 at OLMo-1B's
# and Jamba's decode on the H100), and a grid of ~3 blocks on each SM.
SPLIT_K_TILE = 64
SPLIT_K_MIN_CHUNK = 3 * SPLIT_K_TILE
SPLIT_K_BLOCKS_PER_SM = 3

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)
_lib = None
_hopper_lib = None
_tf32_lib = None
_sm_counts = {}


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int, Sq: int,
          *, tma_ok: bool = True) -> str:
    """The route a call takes: "tensor_core", "split_k", "tf32x3" or
    "cuda_core".
    ``tma_ok``: q, k and v have 16-byte-aligned bases and strides (TMA's
    rule).  Raises on a head dim or type pair no kernel takes."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernels take {HEAD_DIMS}")
    if (q_dtype, kv_dtype) not in DTYPES:
        raise TypeError(f"q {q_dtype}, k/v {kv_dtype}: the kernels take "
                        f"(q, k/v) in {DTYPES}")
    if (q_dtype == kv_dtype == torch.bfloat16 and hd in HOPPER_HEAD_DIMS):
        if Sq <= SPLIT_K_MAX_QUERIES:
            return "split_k"
        if tma_ok:
            return "tensor_core"
    if (q_dtype == kv_dtype == torch.float32 and hd in TF32_HEAD_DIMS
            and Sq > SPLIT_K_MAX_QUERIES and tma_ok):
        return "tf32x3"
    return "cuda_core"


def split_k_chunk(Sk: int, groups: int, sms: int) -> int:
    """Keys per chunk for a cache of ``Sk`` positions, ``groups`` = B * KV
    (batch rows x KV heads) and a card of ``sms`` SMs: Sk * groups / (sms *
    SPLIT_K_BLOCKS_PER_SM) rounded up to a multiple of 64, and at least
    SPLIT_K_MIN_CHUNK, so ``groups * ceil(Sk / chunk)`` blocks come to at
    most about sms * SPLIT_K_BLOCKS_PER_SM (one chunk more per group).  It
    reads only the shapes: no host sync on kv_len."""
    per_block = -(-Sk * groups // (sms * SPLIT_K_BLOCKS_PER_SM))
    return max(SPLIT_K_MIN_CHUNK, -(-per_block // SPLIT_K_TILE) * SPLIT_K_TILE)


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once for each card."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _sm_counts:
        props = torch.cuda.get_device_properties(index)
        _sm_counts[index] = props.multi_processor_count
    return _sm_counts[index]


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (SOURCE, HOPPER_SOURCE or TF32_SOURCE) unless its
    library is already built; returns the library's path."""
    return nvcc.build(source)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(SOURCE)))
        fn = lib.flash_attention_fwd
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([ptr] * 5 + [i32] * 9 + [i64] * 9
                       + [i32, i32, i64, ctypes.c_float, i32, i32, i32, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _load_hopper():
    global _hopper_lib
    if _hopper_lib is None:
        lib = ctypes.CDLL(str(build(HOPPER_SOURCE)))
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        common = [i32] * 7 + [i64] * 9 + [i32, i32, i64, ctypes.c_float]
        lib.flash_attention_tc_fwd.argtypes = [ptr] * 5 + common + [i32, ptr]
        lib.flash_attention_split_k_fwd.argtypes = ([ptr] * 6 + common
                                                    + [i32] * 3 + [ptr])
        lib.flash_attention_tc_fwd.restype = ctypes.c_int
        lib.flash_attention_split_k_fwd.restype = ctypes.c_int
        _hopper_lib = lib
    return _hopper_lib


def _load_tf32():
    global _tf32_lib
    if _tf32_lib is None:
        lib = ctypes.CDLL(str(build(TF32_SOURCE)))
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn = lib.flash_attention_tf32_fwd
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 9
                       + [i32, i32, i64, ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
        _tf32_lib = lib
    return _tf32_lib


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte loads (and TMA): the base and every stride land on 16
    bytes."""
    per16 = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % per16 == 0 and s > 0 for s in t.stride()[:-1]))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         kv_len: Union[None, int, torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the route's kernels on the current stream.  q (B, Sq, H, hd);
    k, v (B, Sk, KV, hd) with H a multiple of KV; any strides with the last
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
    if v.dtype != k.dtype:
        raise TypeError(f"k is {k.dtype} and v {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    q_vec, k_vec, v_vec = _vec_ok(q), _vec_ok(k), _vec_ok(v)
    which = route(q.dtype, k.dtype, hd, Sq, tma_ok=q_vec and k_vec and v_vec)
    if Sk == 0:
        raise ValueError("k and v hold no keys")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_BATCH}")
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
    masks = (int(causal), 0 if window is None else int(window), int(q_offset),
             float(hd ** -0.5))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if which in ("tensor_core", "tf32x3"):
        fn = (_load_hopper().flash_attention_tc_fwd if which == "tensor_core"
              else _load_tf32().flash_attention_tf32_fwd)
        args = (*ptrs, kv_ptr, kv_all, B, Sq, Sk, H, KV, hd, *strides, *masks,
                _sm_count(q.device))
    elif which == "split_k":
        chunk = split_k_chunk(Sk, B * KV, _sm_count(q.device))
        n_part = B * KV * -(-Sk // chunk) * Sq * (H // KV) * (hd + 2)
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
        fn = _load_hopper().flash_attention_split_k_fwd
        args = (*ptrs, part.data_ptr(), kv_ptr, kv_all, B, Sq, Sk, H, KV, hd,
                *strides, *masks, chunk, int(k_vec), int(v_vec))
    else:
        fn = _load().flash_attention_fwd
        args = (*ptrs, kv_ptr, kv_all, int(q.dtype == torch.bfloat16),
                int(k.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd,
                *strides, *masks, int(q_vec), int(k_vec), int(v_vec))
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed on the {which} "
                           f"route: error {err}")
    launches += 1
    route_launches[which] += 1
    return out
