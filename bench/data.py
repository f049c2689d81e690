"""The benchmark's inputs, made from ``--seed`` on the device with one
``torch.Generator``: the initial global model and the clients' and the
server's data.

The images are the CIFAR-like problem the port's own generator draws
(``data/synthetic.py::make_cifar_like``: a smooth random template a class,
normalised; an image is its template plus pixel noise, times a random
brightness), here rewritten in plain PyTorch: 10 classes of 32 x 32 x 3
images, float32, labels int32.  The split is IID (a shuffle, then equal
shares) and each share is cut into batches, as ``client_batches`` does.
The same seed gives the same inputs, at every size.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import List

import torch


@dataclasses.dataclass
class Inputs:
    weights: torch.Tensor          # (D,) float32, the genome order
    clients: List[dict]            # images (nb, B, H, W, C), labels (nb, B)
    eval: dict                     # images (n, H, W, C), labels (n,)


def initial_weights(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Weights ~ N(0, 1 / fan-in), biases 0, as one flat draw."""
    mod = importlib.import_module(f"bench.models.{cfg['model']}")
    fan = mod.fan_in(cfg)
    layout = mod.layout(cfg)
    sizes = [math.prod(s) for _, s in layout]
    scale = torch.tensor([0.0 if name.endswith(".b")
                          else fan[name.split(".")[0]] ** -0.5
                          for name, _ in layout], device=device)
    scale = torch.repeat_interleave(scale, torch.tensor(sizes, device=device))
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    return draw * scale


def _smooth(x, passes: int = 3):
    for _ in range(passes):
        x = (x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
             + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)) / 5.0
    return x


def cifar_like(gen, n_train: int, n_test: int, image_size: int,
               channels: int, num_classes: int, device,
               noise: float = 0.35):
    shape = (image_size, image_size, channels)
    t = _smooth(torch.randn((num_classes, *shape), generator=gen,
                            device=device))
    t = t / (t.std(dim=(1, 2, 3), correction=0, keepdim=True) + 1e-6)

    def build(n):
        labels = torch.randint(0, num_classes, (n,), generator=gen,
                               device=device, dtype=torch.int32)
        imgs = t[labels.long()] + noise * torch.randn(
            (n, *shape), generator=gen, device=device)
        bright = 1.0 + 0.1 * torch.randn((n, 1, 1, 1), generator=gen,
                                         device=device)
        return {"images": imgs * bright, "labels": labels}

    return build(n_train), build(n_test)


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    weights = initial_weights(cfg, gen, device)
    train, test = cifar_like(gen, traffic["n_train"], traffic["n_test"],
                             cfg["image_size"], cfg["channels"],
                             cfg["num_classes"], device)
    if traffic["partition"] != "iid":
        raise ValueError(f"no split {traffic['partition']!r}: only 'iid'")
    n, B = traffic["n_clients"], traffic["batch_size"]
    per = traffic["n_train"] // n
    perm = torch.randperm(traffic["n_train"], generator=gen, device=device)
    clients = []
    for k in range(n):
        idx = perm[k * per:(k + 1) * per]
        nb = len(idx) // B
        idx = idx[:nb * B]
        clients.append({"images": train["images"][idx].reshape(
                            nb, B, *train["images"].shape[1:]),
                        "labels": train["labels"][idx].reshape(nb, B)})
    return Inputs(weights, clients, test)

