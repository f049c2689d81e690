"""The paper's CNN (FedBWO, arXiv:2505.04435, §IV-A), plain PyTorch.

Conv kxk (channels -> f1), conv 3x3 (f1 -> f1), 2x2 max pool, conv kxk
(f1 -> f2), conv 3x3 (f2 -> f2), 2x2 max pool, flatten in (H, W, C)
order, dense -> hidden, dropout (training only), dense -> hidden, dense ->
classes; ReLU after every layer but the last; stride 1 and SAME padding.
Weights are laid out as the FL genome is: convolutions (kh, kw, cin,
cout), dense (in, out), layers in name order, each layer's bias before its
weight.  Images come in (B, H, W, C); the data and the loss are the
classifiers' (``classifier.py``).

``mm`` is applied to both operands of every product (the control's
rounding on a device without TF32); by default it is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.models.classifier import cross_entropy, make_data  # noqa: F401


def _ident(x):
    return x


def layers(cfg: dict) -> list:
    """``(name, kind, kh, kw, cin, cout)`` of each layer with weights."""
    k, c, f1, f2 = cfg["kernel"], cfg["channels"], cfg["conv1_filters"], \
        cfg["conv2_filters"]
    h, n = cfg["dense_hidden"], cfg["num_classes"]
    flat = (cfg["image_size"] // 4) ** 2 * f2
    return [("conv1a", "conv", k, k, c, f1), ("conv1b", "conv", 3, 3, f1, f1),
            ("conv2a", "conv", k, k, f1, f2), ("conv2b", "conv", 3, 3, f2, f2),
            ("fc1", "dense", 1, 1, flat, h), ("fc2", "dense", 1, 1, h, h),
            ("out", "dense", 1, 1, h, n)]


def layout(cfg: dict) -> list:
    """``(leaf name, shape)`` in genome order."""
    out = []
    for name, kind, kh, kw, cin, cout in sorted(layers(cfg)):
        out.append((f"{name}.b", (cout,)))
        out.append((f"{name}.w", (kh, kw, cin, cout) if kind == "conv"
                    else (cin, cout)))
    return out


def fan_in(cfg: dict) -> dict:
    return {name: kh * kw * cin for name, _, kh, kw, cin, _ in layers(cfg)}


def forward_flops(cfg: dict) -> int:
    """Multiply-adds of one image's forward pass, times 2 (SAME padding:
    every output position counts the whole kernel)."""
    s = cfg["image_size"]
    side = {"conv1a": s, "conv1b": s, "conv2a": s // 2, "conv2b": s // 2}
    total = 0
    for name, kind, kh, kw, cin, cout in layers(cfg):
        pos = side[name] ** 2 if kind == "conv" else 1
        total += pos * kh * kw * cin * cout
    return 2 * total


def dropout_shape(cfg: dict, batch: int):
    """The shape of the keep mask of one training batch (after fc1)."""
    return (batch, cfg["dense_hidden"])


def _conv(p, name, x, mm):
    w = p[f"{name}.w"].permute(3, 2, 0, 1)            # (kh,kw,ci,co) -> OIHW
    y = F.conv2d(mm(x), mm(w), padding=w.shape[-1] // 2)
    return F.relu(y + p[f"{name}.b"][None, :, None, None])


def _dense(p, name, x, mm):
    return mm(x) @ mm(p[f"{name}.w"]) + p[f"{name}.b"]


def logits(cfg: dict, p: dict, images, keep=None, mm=_ident):
    """(B, H, W, C) -> (B, classes).  ``keep``: the dropout keep mask of a
    training batch, or None (evaluation)."""
    x = images.permute(0, 3, 1, 2)
    x = _conv(p, "conv1b", _conv(p, "conv1a", x, mm), mm)
    x = F.max_pool2d(x, 2)
    x = _conv(p, "conv2b", _conv(p, "conv2a", x, mm), mm)
    x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
    x = F.relu(_dense(p, "fc1", x, mm))
    if keep is not None:
        rate = cfg["dropout"]
        x = torch.where(keep, x / (1 - rate), torch.zeros_like(x))
    x = F.relu(_dense(p, "fc2", x, mm))
    return _dense(p, "out", x, mm)


def loss(cfg: dict, p: dict, batch: dict, keep=None, mm=_ident):
    """Mean negative log-likelihood and accuracy of a batch of
    ``images`` and ``labels``."""
    return cross_entropy(logits(cfg, p, batch["images"], keep, mm),
                         batch["labels"])
