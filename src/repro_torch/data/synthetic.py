"""Synthetic datasets, drawn from the same keys as the reference's, so a
seed gives the same labels and the same images (within float32 rounding).

``make_cifar_like`` builds a *learnable* 10-class 32x32x3 image problem:
each class has a random smooth template; samples are the template plus
pixel noise and random brightness.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.client import Task
from repro_torch.models import cnn as cnn_lib


def _smooth(key, shape, passes: int = 3):
    x = random.normal(key, shape)
    for _ in range(passes):
        x = (x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
             + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) / 5.0
    return x


def make_cifar_like(key, n_train: int = 10000, n_test: int = 2000,
                    num_classes: int = 10, image_size: int = 32,
                    noise: float = 0.35) -> Tuple[dict, dict]:
    """Returns (train, test) dicts of images (N,32,32,3) fp32 / labels
    int32, on the key's device."""
    rt, rl, rn, rlt, rnt, _ = random.split(key, 6)
    templates = torch.stack([_smooth(k, (image_size, image_size, 3))
                             for k in random.split(rt, num_classes)])
    templates = templates / (templates.std(dim=(1, 2, 3), correction=0,
                                           keepdim=True) + 1e-6)

    def build(rng_lbl, rng_noise, n):
        labels = random.randint(rng_lbl, (n,), 0, num_classes)
        base = templates[labels.long()]
        k1, k2 = random.split(rng_noise)
        imgs = base + noise * random.normal(k1, tuple(base.shape))
        bright = 1.0 + 0.1 * random.normal(k2, (n, 1, 1, 1))
        return {"images": (imgs * bright).to(torch.float32),
                "labels": labels}

    return build(rl, rn, n_train), build(rlt, rnt, n_test)


def cnn_task(cfg: CNNConfig = CNNConfig()) -> Task:
    def init_params(key):
        return cnn_lib.cnn_init(key, cfg)

    def loss_fn(params, batch):
        rng = batch.get("rng") if isinstance(batch, dict) else None
        return cnn_lib.cnn_loss(params, batch["images"], batch["labels"],
                                train=rng is not None, dropout_rng=rng)

    return Task(init_params, loss_fn)


def mlp_task(hidden: int = 200, image_size: int = 32, channels: int = 3,
             num_classes: int = 10) -> Task:
    """The original FedAvg paper's "2NN" model: flatten -> two hidden
    dense layers -> softmax, on the same CIFAR-like images."""
    d_in = image_size * image_size * channels

    def init_params(key):
        r1, r2, r3 = random.split(key, 3)

        def dense(r, m, n):
            return {"w": random.normal(r, (m, n)) * (1.0 / m) ** 0.5,
                    "b": torch.zeros((n,), device=key.device)}

        return {"fc1": dense(r1, d_in, hidden),
                "fc2": dense(r2, hidden, hidden),
                "out": dense(r3, hidden, num_classes)}

    def loss_fn(params, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
        x = F.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
        logits = x @ params["out"]["w"] + params["out"]["b"]
        lp = F.log_softmax(logits, dim=-1)
        labels = batch["labels"]
        nll = -lp.gather(-1, labels[:, None].long()).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, acc

    return Task(init_params, loss_fn)
