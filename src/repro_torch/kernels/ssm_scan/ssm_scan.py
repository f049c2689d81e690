"""The selective-SSM scan (the Mamba recurrence) as a hand-written CUDA
kernel for Hopper.

Replaces ``repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_pallas``; the
source, with its bound and design, is ``repro_torch/csrc/ssm_scan.cu``.  The
kernel is compiled with ``nvcc`` at first use (never at import) by
``repro_torch.kernels.nvcc`` and loaded with ``ctypes``.

``launches`` counts every launch of the kernel: a run can show that its
path went through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.SOURCE_DIR / "ssm_scan.cu"
STATE_DIMS = (4, 8, 16)
MAX_BATCH = 65535                 # the grid's second dimension

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
        fn = lib.ssm_scan_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous float32, got {t.dtype}"
                        f"{'' if t.is_contiguous() else ', strided'}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")


def ssm_scan_cuda(x, dt, A, Bc, Cc, h0: Optional[torch.Tensor] = None, *,
                  h_out: Optional[torch.Tensor] = None):
    """Launch the kernel on the current stream.  x, dt (B, S, D); A (D, N);
    Bc, Cc (B, S, N); h0 (B, D, N) or None (zeros); all contiguous float32
    on one card.  ``h_out``, a (B, D, N) float32 tensor, receives the last
    state and may be ``h0`` itself (each element is read before it is
    written).  Returns (y (B, S, D), h (B, D, N)), float32."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda takes CUDA tensors, got {x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x is (B, S, D) and A is (D, N)")
    B, S, D = x.shape
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N}: the kernel takes {STATE_DIMS}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B}: the kernel takes at most {MAX_BATCH}")
    dev = x.device
    for name, t, shape in (("x", x, (B, S, D)), ("dt", dt, (B, S, D)),
                           ("A", A, (D, N)), ("Bc", Bc, (B, S, N)),
                           ("Cc", Cc, (B, S, N))):
        _check(name, t, shape, dev)
    if h0 is not None:
        _check("h0", h0, (B, D, N), dev)
    if h_out is None:
        h_out = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    else:
        _check("h_out", h_out, (B, D, N), dev)
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        return y, h_out
    fn = _load().ssm_scan_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_out.data_ptr(), B, S, D, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    launches += 1
    return y, h_out
