"""The gradient of the selective-SSM scan as a hand-written CUDA kernel for
Hopper.

The backward of ``ops.ssm_scan`` on a CUDA tensor; the source, with its
bound and design, is ``repro_torch/csrc/ssm_scan_bwd.cu``: four lanes a
channel, a pass that stores the state every few steps, then the steps in
reverse, each tile's states recomputed from its stored state into
registers, then the sums over channel blocks in a fixed order (no
atomics: the same bits on every run).  The kernel is
compiled with ``nvcc`` at first use (never at import) by
``repro_torch.kernels.nvcc`` and loaded with ``ctypes``.

``launches`` counts every call that launched the kernel's passes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ssm_scan.ssm_scan import (MAX_BATCH, STATE_DIMS,
                                                   _check)

SOURCE = nvcc.SOURCE_DIR / "ssm_scan_bwd.cu"

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
        fn = lib.ssm_scan_bwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 17 + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
        for name in ("ssm_scan_bwd_ckpt_steps", "ssm_scan_bwd_block_channels"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def ssm_scan_bwd_cuda(x, dt, A, Bc, Cc, h0: Optional[torch.Tensor], dy,
                      dh: Optional[torch.Tensor] = None):
    """Launch the backward on the current stream.  x, dt, dy (B, S, D); A
    (D, N); Bc, Cc (B, S, N); h0 and dh (the gradient of the last state)
    (B, D, N) or None; all contiguous float32 on one card.  Returns (dx,
    ddt, dA, dB, dC, dh0), float32, dh0 None without h0."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd_cuda takes CUDA tensors, got {x.device}")
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
                           ("Cc", Cc, (B, S, N)), ("dy", dy, (B, S, D))):
        _check(name, t, shape, dev)
    for name, t in (("h0", h0), ("dh", dh)):
        if t is not None:
            _check(name, t, (B, D, N), dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA = torch.zeros_like(A)
    dB, dC = torch.zeros_like(Bc), torch.zeros_like(Cc)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if B == 0 or D == 0 or S == 0:
        dx.zero_()
        ddt.zero_()
        if dh0 is not None:                   # no step: h is h0
            dh0.copy_(dh if dh is not None else torch.zeros_like(h0))
        return dx, ddt, dA, dB, dC, dh0
    lib = _load()
    steps = lib.ssm_scan_bwd_ckpt_steps()
    blocks = -(-D // lib.ssm_scan_bwd_block_channels())
    ckpt = torch.empty((B, -(-S // steps), D, N), dtype=torch.float32,
                       device=dev)
    part = torch.empty((B, S, blocks, 2 * N), dtype=torch.float32, device=dev)
    dA_part = torch.empty((B, D, N), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.ssm_scan_bwd(
            *(ptr(t) for t in (x, dt, A, Bc, Cc, h0, dy, dh, ckpt, part,
                               dA_part, dx, ddt, dA, dB, dC, dh0)),
            B, S, D, N, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: cudaError {err}")
    launches += 1
    return dx, ddt, dA, dB, dC, dh0
