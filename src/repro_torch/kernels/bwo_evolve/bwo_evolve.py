"""The fused BWO generation as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/bwo_evolve/bwo_evolve.py::bwo_evolve_pallas``;
the source, with its bound and design, is ``repro_torch/csrc/bwo_evolve.cu``.

The kernel is compiled with ``nvcc`` at first use (never at import) by
``repro_torch.kernels.nvcc`` and loaded with ``ctypes``.

``launches`` counts every launch of the kernel: a run can show that its
main path went through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.SOURCE_DIR / "bwo_evolve.cu"

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
        fn = lib.bwo_evolve_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, device, dtypes, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_WORDS = (torch.int32, torch.uint32)
MAX_ROWS = 65535             # the grid's y extent: one row of blocks a child


def bwo_evolve_cuda(pop, p1_idx, p2_idx, bits1, bits2, row_gate, *,
                    pm_gene: float, mut_scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream.  pop (P, D) float32; p1_idx,
    p2_idx (P,) int32; bits1, bits2 (P, Dp) 32-bit words (int32 or
    uint32), Dp >= D; row_gate (P, 1) float32; all contiguous on one CUDA
    device; P <= MAX_ROWS (under vmap, P is clients times population).
    Returns the children, (P, D) float32."""
    global launches
    if pop.device.type != "cuda":
        raise ValueError(f"bwo_evolve_cuda takes CUDA tensors, got {pop.device}")
    if pop.dim() != 2 or bits1.dim() != 2:
        raise ValueError("pop and the bits are (P, D) and (P, Dp)")
    P, D = pop.shape
    Dp = bits1.shape[1]
    if P > MAX_ROWS:
        raise ValueError(f"{P} child rows exceed the grid's {MAX_ROWS}: "
                         f"launch fewer clients times population at once")
    if Dp < D:
        raise ValueError(f"bits are {Dp} wide, fewer than the {D} genes")
    dev = pop.device
    _check("pop", pop, dev, (torch.float32,), (P, D))
    _check("p1_idx", p1_idx, dev, (torch.int32,), (P,))
    _check("p2_idx", p2_idx, dev, (torch.int32,), (P,))
    _check("bits1", bits1, dev, _WORDS, (P, Dp))
    _check("bits2", bits2, dev, _WORDS, (P, Dp))
    _check("row_gate", row_gate, dev, (torch.float32,), (P, 1))
    fn = _load().bwo_evolve_f32
    out = torch.empty((P, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pop.data_ptr(), p1_idx.data_ptr(), p2_idx.data_ptr(),
                 bits1.data_ptr(), bits2.data_ptr(), row_gate.data_ptr(),
                 out.data_ptr(), P, D, Dp, int(pm_gene * 256),
                 float(mut_scale), stream)
    if err != 0:
        raise RuntimeError(f"bwo_evolve launch failed: cudaError {err}")
    launches += 1
    return out
