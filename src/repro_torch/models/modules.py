"""Param-dict module helpers: ``*_init(key, ...) -> params`` and
``*_apply(params, x) -> y`` on plain tensors, in the reference's layouts
(dense ``w`` (in, out); conv weights HWIO; activations NHWC; attention
activations (B, S, H, hd)).  The pieces the paper CNN and the dense
transformer use are ported, with the reference's ``tp_weight`` (a
sharding constraint, an identity without a mesh context)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.sharding.context import constrain, is_dtensor, local_dims


def _normal(key, shape, scale, dtype):
    """``normal(key, shape) * scale`` cast to ``dtype``, piece by piece as a
    large draw is made (the cast is elementwise: the same values)."""
    return random.fill(
        key, shape, lambda start, n: (random.normal_at(key, start, n)
                                      * scale).to(dtype), dtype)


# ---------------------------------------------------------------- dense --
def dense_init(key, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.bfloat16, scale: Optional[float] = None):
    scale = scale if scale is not None else in_dim ** -0.5
    p = {"w": _normal(key, (in_dim, out_dim), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=key.device)
    return p


def dense_apply(p, x):
    """``x @ w (+ b)``.  Operands of two types compute in the wider, as
    JAX's promotion does in the reference's products: float32 activations
    (Whisper's frames) take bf16 weights as float32, whose values stay
    bf16's."""
    w = p["w"]
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- norms --
def norm_init(kind: str, dim: int, dtype=torch.bfloat16, *, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "layernorm_np":          # OLMo: non-parametric LN
        return {}
    raise ValueError(kind)


def norm_apply(kind: str, p, x, eps: float = 1e-5):
    """Normalise over the last axis in float32; the result in x's dtype.
    The variance is the population variance, as ``jnp.var``'s."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------ embedding --
def embedding_init(key, vocab: int, dim: int, dtype=torch.bfloat16):
    return {"table": _normal(key, (vocab, dim), 1.0, dtype)}


def embedding_apply(p, ids):
    table = p["table"]
    if is_dtensor(table):
        # on a mesh each rank looks its own rows up in the table gathered
        # over the vocabulary (its model columns); its gradient covers
        # those rows alone
        rows = ("b" if is_dtensor(ids) else ".") + "." * (ids.dim() - 1)
        return local_dims(lambda t, i: t[i],
                          (table, ".m+b" if "b" in rows else ".m"),
                          (ids, rows), out=rows + "m")
    return table[ids]


def embedding_attend(p, x):
    """Tied-embedding logits."""
    return x @ p["table"].T


# ----------------------------------------------------------------- rope --
def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-halves RoPE.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ ffn --
def ffn_init(key, kind: str, d_model: int, d_ff: int, dtype=torch.bfloat16):
    r = random.split(key, 3)
    if kind == "swiglu":
        return {"wi": dense_init(r[0], d_model, d_ff, dtype=dtype),
                "wg": dense_init(r[1], d_model, d_ff, dtype=dtype),
                "wo": dense_init(r[2], d_ff, d_model, dtype=dtype)}
    if kind == "gelu":
        return {"wi": dense_init(r[0], d_model, d_ff, dtype=dtype),
                "wo": dense_init(r[1], d_ff, d_model, dtype=dtype)}
    raise ValueError(kind)


def tp_weight(p, *axes):
    """FSDP -> TP reshard of a weight before use.

    Storage sharding is ZeRO-3 (both dims sharded); computing directly
    from that gathers *activations* (B, S, d_ff) instead of weights.
    Constraining the weight to its Megatron layout (contracting dim
    replicated, output dim on ``model``) makes it a per-layer weight
    all-gather over ``data`` -- the FSDP schedule.  Without a mesh context
    ``p`` comes back as it is."""
    w = constrain(p["w"], *axes)
    if w is p["w"]:
        return p
    return dict(p, w=w)


def ffn_apply(kind: str, p, x):
    if kind == "swiglu":
        h = (F.silu(dense_apply(tp_weight(p["wg"], None, "model"), x))
             * dense_apply(tp_weight(p["wi"], None, "model"), x))
    else:                               # jax.nn.gelu's tanh approximation
        h = F.gelu(dense_apply(tp_weight(p["wi"], None, "model"), x),
                   approximate="tanh")
    return dense_apply(tp_weight(p["wo"], "model", None), h)


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
