"""The paper's experimental CNN (Section IV-A), in PyTorch.

Conv2D(5x5,32) -> Conv2D(3x3,32) -> maxpool -> Conv2D(5x5,64)
-> Conv2D(3x3,64) -> maxpool -> flatten -> Dense(512) -> Dense(512)
-> Dense(10), with the reference's parameter dict and NHWC layout, so a
flat genome and a JAX checkpoint carry across element for element.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import modules as nn


def cnn_init(key, cfg: CNNConfig):
    r = random.split(key, 7)
    flat = (cfg.image_size // 4) ** 2 * cfg.conv2_filters      # 8*8*64 = 4096
    return {
        "conv1a": nn.conv2d_init(r[0], cfg.kernel, cfg.kernel, cfg.channels,
                                 cfg.conv1_filters),
        "conv1b": nn.conv2d_init(r[1], 3, 3, cfg.conv1_filters,
                                 cfg.conv1_filters),
        "conv2a": nn.conv2d_init(r[2], cfg.kernel, cfg.kernel,
                                 cfg.conv1_filters, cfg.conv2_filters),
        "conv2b": nn.conv2d_init(r[3], 3, 3, cfg.conv2_filters,
                                 cfg.conv2_filters),
        "fc1": nn.dense_init(r[4], flat, cfg.dense_hidden, bias=True,
                             dtype=torch.float32),
        "fc2": nn.dense_init(r[5], cfg.dense_hidden, cfg.dense_hidden,
                             bias=True, dtype=torch.float32),
        "out": nn.dense_init(r[6], cfg.dense_hidden, cfg.num_classes,
                             bias=True, dtype=torch.float32),
    }


def cnn_apply(params, images, *, train: bool = False, dropout_rng=None,
              dropout: float = 0.2):
    """images: (B, 32, 32, 3) -> logits (B, 10)."""
    x = F.relu(nn.conv2d_apply(params["conv1a"], images))
    x = F.relu(nn.conv2d_apply(params["conv1b"], x))
    x = nn.maxpool2(x)
    x = F.relu(nn.conv2d_apply(params["conv2a"], x))
    x = F.relu(nn.conv2d_apply(params["conv2b"], x))
    x = nn.maxpool2(x)
    x = x.reshape(x.shape[0], -1)          # NHWC order, as fc1's rows expect
    x = F.relu(nn.dense_apply(params["fc1"], x))
    if train and dropout_rng is not None and dropout > 0:
        keep = random.bernoulli(dropout_rng, 1 - dropout, tuple(x.shape))
        x = torch.where(keep, x / (1 - dropout), 0.0)
    x = F.relu(nn.dense_apply(params["fc2"], x))
    return nn.dense_apply(params["out"], x)


def cnn_loss(params, images, labels, *, train=False, dropout_rng=None):
    logits = cnn_apply(params, images, train=train, dropout_rng=dropout_rng)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long()).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc
