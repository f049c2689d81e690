"""Param-dict module helpers: ``*_init(key, ...) -> params`` and
``*_apply(params, x) -> y`` on plain tensors, in the reference's layouts
(dense ``w`` (in, out); conv weights HWIO; activations NHWC).  Only the
pieces the paper CNN uses are ported."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import random


def _normal(key, shape, scale, dtype):
    return (random.normal(key, shape, torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------- dense --
def dense_init(key, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.bfloat16, scale: Optional[float] = None):
    scale = scale if scale is not None else in_dim ** -0.5
    p = {"w": _normal(key, (in_dim, out_dim), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=key.device)
    return p


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ------------------------------------------------------------ conv (cnn) --
def conv2d_init(key, kh: int, kw: int, cin: int, cout: int,
                dtype=torch.float32):
    scale = (kh * kw * cin) ** -0.5
    return {"w": _normal(key, (kh, kw, cin, cout), scale, dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=key.device)}


def conv2d_apply(p, x):
    """x: (B, H, W, C) -> (B, H, W, cout), stride 1, SAME padding (odd
    kernels).  An NHWC tensor permuted to NCHW is channels-last in
    memory, which cuDNN takes as it is."""
    w = p["w"].permute(3, 2, 0, 1)                    # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1) + p["b"]


def maxpool2(x):
    """2x2 max pool, stride 2, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
