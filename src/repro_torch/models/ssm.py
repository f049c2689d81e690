"""The Mamba selective-SSM block (Jamba's mixer): the port of
``repro/models/ssm.py``.

The reference computes the recurrence of train and prefill with a chunked
``lax.associative_scan`` and the decode step as one explicit step of it;
both are the function its ``ssm_scan`` kernel computes (y before the
D-skip, and the last state).  Here every scan goes through
``kernels.ssm_scan.ops.ssm_scan``: the hand-written CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  Train and prefill scan from a
zero state; decode scans one step from the cached state.

The state is a dict of views into the model's cache (see
``transformer.Model.apply``), so prefill and decode write the new ``h`` and
``conv`` into it in place: the kernel writes h straight into the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import modules as nn
from repro_torch.sharding.context import (batch_axes, constrain, is_dtensor,
                                          local_dims)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(1, cfg.d_model // 16)
    return di, dt_rank, s.state_dim, s.conv_width


def mamba_init(key, cfg: ArchConfig):
    """The reference's key schedule: split(key, 6).  ``A_log`` and ``D``
    stay float32 whatever the model's dtype."""
    di, dt_rank, N, cw = _dims(cfg)
    d = cfg.d_model
    r = random.split(key, 6)
    dt = cfg.param_dtype
    dev = key.device
    return {
        "in_proj": nn.dense_init(r[0], d, 2 * di, dtype=dt),
        "conv_w": (random.normal(r[1], (cw, di), torch.float32)
                   * cw ** -0.5).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": nn.dense_init(r[2], di, dt_rank + 2 * N, dtype=dt),
        "dt_proj": nn.dense_init(r[3], dt_rank, di, bias=True, dtype=dt),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": nn.dense_init(r[4], di, d, dtype=dt),
    }


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                     device):
    di, _, N, cw = _dims(cfg)
    return {"h": torch.zeros((batch, di, N), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cw - 1, di), dtype=dtype,
                                device=device)}


def _causal_conv(x, w, b, conv_state=None):
    """x: (B, S, di); w: (cw, di) depthwise.  The taps are summed from 0 in
    ascending order, as the reference's Python ``sum``, so bf16 sums round
    as its do."""
    cw = w.shape[0]
    if conv_state is None and is_dtensor(x):
        # on a mesh the taps run on each rank's rows and channels; the
        # weights' gradients are sums over the ranks' rows
        return local_dims(_causal_conv, (x, "b.m"), (w, ".m+b"), (b, "m+b"),
                          out="b.m")
    if conv_state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    return y + b


def _ssm_params(p, x_in, cfg):
    """Common dt/B/C computation.  x_in: (B, S, di)."""
    _, dt_rank, N, _ = _dims(cfg)
    xdb = nn.dense_apply(p["x_proj"], x_in)
    dt_raw, B_ssm, C_ssm = torch.split(xdb, [dt_rank, N, N], dim=-1)
    dt = F.softplus(nn.dense_apply(p["dt_proj"], dt_raw).float())
    A = -torch.exp(p["A_log"])                                 # (di, N)
    return dt, A, B_ssm.float(), C_ssm.float()


def mamba_apply(p, x, *, cfg: ArchConfig, mode: str, state=None):
    """x: (B, S, d) -> (y, state).  Prefill (with a state) and decode write
    the new state into ``state`` in place and return it."""
    S = x.shape[1]
    cw = cfg.ssm.conv_width
    if is_dtensor(x) and mode == "decode":
        # one token's product is smaller than the weight: column-parallel,
        # gathered over ``model`` once and the halves resharded (XLA
        # permutes them)
        xz = constrain(nn.dense_apply(nn.tp_weight(p["in_proj"], None,
                                                   "model"), x),
                       batch_axes(), None, None)
        x_in, z = (constrain(t, batch_axes(), None, "model")
                   for t in xz.chunk(2, dim=-1))
    elif is_dtensor(x):
        # on a mesh the halves are two column-parallel products: chunking
        # one product's model-sharded columns would gather them whole
        w = p["in_proj"]["w"]
        di = w.shape[1] // 2
        x_in, z = (nn.dense_apply(nn.tp_weight({"w": h}, None, "model"), x)
                   for h in (w[:, :di], w[:, di:]))
    else:
        xz = nn.dense_apply(p["in_proj"], x)
        x_in, z = xz.chunk(2, dim=-1)

    if mode == "decode":
        # one step of the recurrence on the cached (h, conv) state
        conv_state = state["conv"]                             # (B, cw-1, di)
        x_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_state)
        new_conv = torch.cat([conv_state, x_in.to(conv_state.dtype)],
                             dim=1)[:, -(cw - 1):]
        x_act = F.silu(x_conv)
        dt, A, B_ssm, C_ssm = _ssm_params(p, x_act, cfg)
        y, _ = ssm_ops.ssm_scan(x_act, dt, A, B_ssm, C_ssm, state["h"],
                                h_out=state["h"])
        state["conv"].copy_(new_conv)
    else:
        # train / prefill: one scan over the sequence from a zero state
        x_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"])
        x_act = F.silu(x_conv)
        dt, A, B_ssm, C_ssm = _ssm_params(p, x_act, cfg)
        # the reference's chunked scan takes only whole chunks
        chunk = min(cfg.ssm.chunk, S)
        if S % chunk:
            raise ValueError(f"seq {S} % chunk {chunk} != 0")
        keep = mode == "prefill" and state is not None
        y, _ = ssm_ops.ssm_scan(x_act, dt, A, B_ssm, C_ssm,
                                h_out=state["h"] if keep else None)
        if keep:
            state["conv"].copy_(x_in[:, -(cw - 1):])
        else:
            state = None
    y = y + p["D"] * x_act.float()
    out = y.to(x.dtype) * F.silu(z)
    return nn.dense_apply(p["out_proj"], out), state
