"""The plain PyTorch versions of the selective-SSM scan and its gradient.

``ssm_scan_ref`` is a port of
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


def ssm_scan_bwd_ref(x, dt, A, Bc, Cc, h0, dy, dh=None):
    """The gradient of ``ssm_scan_ref`` at cotangents ``dy`` (B, S, D) and
    ``dh`` (B, D, N, the last state's; None for zeros), as the backward
    kernel computes it: the states stored on a pass forward, then, with
    a_t = exp(dt_t A), u_t = dt_t x_t and the state's gradient
    g_t = a_{t+1} g_{t+1} + dy_t C_t, step by step back

        dx_t = (g_t . B_t) dt_t     ddt_t = (g_t . B_t) x_t + sum_n g_t a_t h_{t-1} A
        dA  += sum_b g_t a_t h_{t-1} dt_t
        dB_t = sum_d g_t u_t        dC_t = sum_d dy_t h_t       dh0 = a_0 g_0.

    Returns (dx, ddt, dA, dB, dC, dh0), float32; dh0 is None without h0."""
    B, S, D = x.shape
    N = A.shape[1]
    x, dt, A, Bc, Cc, dy = (t.float() for t in (x, dt, A, Bc, Cc, dy))
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = [h]                                    # hs[t]: the state before t
    for t in range(S):
        h = h * torch.exp(dt[:, t, :, None] * A) \
            + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh is None else dh.float().clone()
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dA = torch.zeros_like(A)
    dB, dC = torch.zeros_like(Bc), torch.zeros_like(Cc)
    for t in reversed(range(S)):
        a = torch.exp(dt[:, t, :, None] * A)                  # (B, D, N)
        g = g + dy[:, t, :, None] * Cc[:, t, None, :]
        dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
        du = torch.einsum("bdn,bn->bd", g, Bc[:, t])
        dx[:, t] = du * dt[:, t]
        gah = g * a * hs[t]
        ddt[:, t] = du * x[:, t] + (gah * A).sum(-1)
        dA += (gah * dt[:, t, :, None]).sum(0)
        g = g * a
    return dx, ddt, dA, dB, dC, (None if h0 is None else g)
