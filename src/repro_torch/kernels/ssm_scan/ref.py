"""The plain PyTorch version of the selective-SSM scan: a port of
``repro/kernels/ssm_scan/ref.py::ssm_scan_ref``, a loop over the steps of
(B, D, N) float32 operations.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
    y_t = (h_t C_t).sum(N)

x/dt: (B, S, D);  Bc/Cc: (B, S, N);  A: (D, N);  h0: (B, D, N) or None.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(x, dt, A, Bc, Cc, h0=None):
    """Returns (y (B, S, D) float32, h (B, D, N) float32).  ``h0`` is read,
    never written."""
    B, S, D = x.shape
    N = A.shape[1]
    x, dt, A, Bc, Cc = (t.float() for t in (x, dt, A, Bc, Cc))
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)                 # (B, D, N)
        h = h * da + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((B, 0, D))
    return y, h
