"""McMahan et al.'s "2NN" (arXiv:1602.05629, §3): flatten, two hidden
dense layers with ReLU, a dense output; plain PyTorch.  Weights are laid
out as the FL genome is: dense (in, out), layers in name order, each
layer's bias before its weight.  Images come in (B, H, W, C) and are
flattened in that order.  No dropout.  ``mm`` as in ``cnn.py``; the data
and the loss are the classifiers' (``classifier.py``).
"""
from __future__ import annotations

import torch.nn.functional as F

from bench.models.classifier import cross_entropy, make_data  # noqa: F401


def _ident(x):
    return x


def layers(cfg: dict) -> list:
    """``(name, in, out)`` of each dense layer."""
    d_in = cfg["image_size"] ** 2 * cfg["channels"]
    h, n = cfg["hidden"], cfg["num_classes"]
    return [("fc1", d_in, h), ("fc2", h, h), ("out", h, n)]


def layout(cfg: dict) -> list:
    out = []
    for name, cin, cout in sorted(layers(cfg)):
        out += [(f"{name}.b", (cout,)), (f"{name}.w", (cin, cout))]
    return out


def fan_in(cfg: dict) -> dict:
    return {name: cin for name, cin, _ in layers(cfg)}


def forward_flops(cfg: dict) -> int:
    return 2 * sum(cin * cout for _, cin, cout in layers(cfg))


def dropout_shape(cfg: dict, batch: int):
    return None


def logits(cfg: dict, p: dict, images, keep=None, mm=_ident):
    x = images.reshape(images.shape[0], -1)
    x = F.relu(mm(x) @ mm(p["fc1.w"]) + p["fc1.b"])
    x = F.relu(mm(x) @ mm(p["fc2.w"]) + p["fc2.b"])
    return mm(x) @ mm(p["out.w"]) + p["out.b"]


def loss(cfg: dict, p: dict, batch: dict, keep=None, mm=_ident):
    """Mean negative log-likelihood and accuracy of a batch of
    ``images`` and ``labels``."""
    return cross_entropy(logits(cfg, p, batch["images"], keep, mm),
                         batch["labels"])
