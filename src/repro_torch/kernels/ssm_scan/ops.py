"""The selective-SSM scan in the reference's public layout — the kernel for
a CUDA tensor, the plain version for a CPU tensor.

The reference's wrapper (``repro/kernels/ssm_scan/ops.py``) also takes
``chunk`` and ``block_d``, the TPU grid's block sizes, halving each until it
divides S and D, and ``interpret``.  The CUDA kernel tiles the steps and the
channels itself and masks ragged edges, so none of them carries over.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssm_scan import ref as ref_lib
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_cuda


def ssm_scan(x, dt, A, Bc, Cc, h0: Optional[torch.Tensor] = None, *,
             h_out: Optional[torch.Tensor] = None):
    """x/dt: (B, S, D); A: (D, N); Bc/Cc: (B, S, N); h0: (B, D, N) or None
    -> (y (B, S, D) float32, h (B, D, N) float32).  Every input is cast to
    float32, as the reference's wrapper casts it.  ``h_out``, a contiguous
    (B, D, N) float32 tensor, receives h (and is returned as h); it may be
    ``h0`` itself, which decode uses to update the cached state in place."""
    x, dt, A, Bc, Cc = (t.to(torch.float32).contiguous()
                        for t in (x, dt, A, Bc, Cc))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    if x.device.type == "cuda":
        return ssm_scan_cuda(x, dt, A, Bc, Cc, h0, h_out=h_out)
    if x.device.type == "cpu":
        y, h = ref_lib.ssm_scan_ref(x, dt, A, Bc, Cc, h0)
        return y, (h if h_out is None else h_out.copy_(h))
    raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
