"""The benchmark's inputs, made from ``--seed`` on the device with one
``torch.Generator``: the initial global model and the clients' and the
server's data.

The configuration's model module (``bench/models/<model>.py``) states what
is its own: the leaves and their fan-in, and its data (``make_data``: a
train and a test dict of tensors with a leading sample axis).  Here the
weights are drawn, then the data, then the split: IID (a shuffle, then
equal shares), each share cut into batches, as ``client_batches`` does,
every tensor of the dict alike.  The same seed gives the same inputs, at
every size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from bench.counts import model_module


@dataclasses.dataclass
class Inputs:
    weights: torch.Tensor          # (D,) float32, the genome order
    clients: List[dict]            # each tensor (n_batches, B, ...)
    eval: dict                     # each tensor (n, ...)


def leaf_fan_in(fan: dict, name: str):
    """A leaf's fan-in: under its full name, or else under the longest
    prefix of its dotted name that ``fan`` holds."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        key = ".".join(parts[:n])
        if key in fan:
            return fan[key]
    raise KeyError(f"no fan-in for the leaf {name!r}")


def initial_weights(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Weights ~ N(0, 1 / fan-in), biases (``.b`` leaves) 0, as one flat
    draw."""
    mod = model_module(cfg)
    fan = mod.fan_in(cfg)
    layout = mod.layout(cfg)
    sizes = [math.prod(s) for _, s in layout]
    scale = torch.tensor([0.0 if name.endswith(".b")
                          else leaf_fan_in(fan, name) ** -0.5
                          for name, _ in layout], device=device)
    scale = torch.repeat_interleave(scale, torch.tensor(sizes, device=device))
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    return draw * scale


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    weights = initial_weights(cfg, gen, device)
    train, test = model_module(cfg).make_data(
        cfg, traffic["n_train"], traffic["n_test"], gen, device)
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
        clients.append({key: v[idx].reshape(nb, B, *v.shape[1:])
                        for key, v in train.items()})
    return Inputs(weights, clients, test)
