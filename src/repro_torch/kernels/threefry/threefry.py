"""The threefry2x32 draws as a hand-written CUDA kernel for Hopper.

Replaces no Pallas kernel: the JAX package draws through ``jax.random``,
which XLA lowers to threefry2x32.  The source, with its bound and design,
is ``repro_torch/csrc/threefry.cu``.

The kernel is compiled with ``nvcc`` at first use (never at import) by
``repro_torch.kernels.nvcc`` and loaded with ``ctypes``.

``launches`` counts every launch of the kernel and ``words`` the counters
it hashed (over all keys): a run can show that its draws went through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels import nvcc

SOURCE = nvcc.SOURCE_DIR / "threefry.cu"
# the kinds of draw and their outputs, as the source numbers them
KINDS = {"pairs": 0, "bits": 1, "uniform": 2, "normal": 3, "bernoulli": 4}
DTYPES = {"pairs": torch.int64, "bits": torch.int32,
          "uniform": torch.float32, "normal": torch.float32,
          "bernoulli": torch.bool}

launches = 0
words = 0
_lib = None
_sms = {}


def build() -> Path:
    """Compile the kernel unless this source's library is already built;
    returns the library's path."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.threefry_draw
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def out_shape(K: int, n: int, kind: str) -> tuple:
    """The output of K keys' draws of n counters: (K, n, 2) key pairs,
    else (K, n)."""
    return (K, n, 2) if kind == "pairs" else (K, n)


def threefry_cuda(keys: torch.Tensor, start: int, n: int, kind: str, *,
                  lo: float = 0.0, hi: float = 1.0,
                  p: float = 0.0) -> torch.Tensor:
    """Launch the kernel on the current stream: the counters
    start..start+n-1 under each of the K keys of ``keys`` ((K, 2) int64 on
    a CUDA device, contiguous; the low 32 bits of each word are the key's),
    as ``kind`` (``KINDS``).  ``lo``, ``hi``: the uniform's interval, whose
    float32 span must be a power of two (``uniform``, ``normal``,
    ``bernoulli``); ``p``: bernoulli's probability.  Returns
    ``out_shape(K, n, kind)`` in ``DTYPES[kind]``."""
    global launches, words
    if keys.device.type != "cuda":
        raise ValueError(f"threefry_cuda takes CUDA keys, got {keys.device}")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {sorted(KINDS)}")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys are (K, 2) int64, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    start, n = int(start), int(n)
    if start < 0 or n < 0 or start + n > 2**64:
        raise ValueError(f"counters {start}..{start + n} leave 0..2^64")
    if kind not in ("pairs", "bits") and not random.span_is_power_of_two(
            lo, hi):
        raise ValueError(f"the kernel's {kind} needs a power-of-two float32 "
                         f"span, got [{lo}, {hi})")
    K, dev = keys.shape[0], keys.device
    out = torch.empty(out_shape(K, n, kind), dtype=DTYPES[kind], device=dev)
    if K == 0 or n == 0:
        return out
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    lo32 = np.float32(lo)
    fn = _load().threefry_draw
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(keys.data_ptr(), K, start, n, KINDS[kind], float(lo32),
                 float(np.float32(hi) - lo32), float(np.float32(p)),
                 out.data_ptr(), _sms[dev.index], stream)
    if err != 0:
        raise RuntimeError(f"threefry launch failed: cudaError {err}")
    launches += 1
    words += K * n
    return out
