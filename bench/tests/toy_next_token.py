"""A toy next-token model, as a configuration brings it: everything the
harness needs of a model, in one module, and its configuration.

An embedding of ``vocab`` ids in ``width``, one dense layer with ReLU, and
an output over the vocabulary, at every position of a ``(B, seq)`` batch
of int tokens; the labels are the next tokens.  The data is a Markov
chain over the ids (each id has one likely successor), so a few SGD steps
lower the loss.  The harness finds the plain parts as
``bench.models.<model>`` and ``port_task`` as ``bench.ports.<model>``;
the tests register this module under both names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CONFIG = {"name": "toy-next-token", "model": "toy_next_token",
          # the port's FLConfig checks the label; port_task gives the task
          "task": "mlp",
          "vocab": 24, "width": 16, "seq": 6, "follow_p": 0.8}


def _ident(x):
    return x


def layout(cfg: dict) -> list:
    V, d = cfg["vocab"], cfg["width"]
    return [("embed.w", (V, d)), ("fc.b", (d,)), ("fc.w", (d, d)),
            ("out.b", (V,)), ("out.w", (d, V))]


def fan_in(cfg: dict) -> dict:
    # the embedding by its leaf's full name, the dense layers by prefix
    return {"embed.w": 1, "fc": cfg["width"], "out": cfg["width"]}


def forward_flops(cfg: dict) -> int:
    d, V = cfg["width"], cfg["vocab"]
    return 2 * cfg["seq"] * (d * d + d * V)


def dropout_shape(cfg: dict, batch: int):
    return None


def make_data(cfg: dict, n_train: int, n_test: int, gen, device):
    V, S = cfg["vocab"], cfg["seq"]
    succ = torch.randperm(V, generator=gen, device=device)

    def build(n):
        ids = [torch.randint(0, V, (n,), generator=gen, device=device)]
        for _ in range(S):
            follow = torch.rand((n,), generator=gen,
                                device=device) < cfg["follow_p"]
            other = torch.randint(0, V, (n,), generator=gen, device=device)
            ids.append(torch.where(follow, succ[ids[-1]], other))
        seq = torch.stack(ids, dim=1)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    return build(n_train), build(n_test)


def logits(p: dict, tokens, mm=_ident):
    x = F.embedding(tokens, p["embed.w"])
    x = F.relu(mm(x) @ mm(p["fc.w"]) + p["fc.b"])
    return mm(x) @ mm(p["out.w"]) + p["out.b"]


def loss(cfg: dict, p: dict, batch: dict, keep=None, mm=_ident):
    """Mean negative log-likelihood of the next token over every position,
    and the accuracy."""
    out = logits(p, batch["tokens"], mm)
    logp = torch.log_softmax(out, dim=-1)
    nll = -logp.gather(-1, batch["labels"][..., None]).mean()
    acc = (out.argmax(-1) == batch["labels"]).to(out.dtype).mean()
    return nll, acc


def port_loss(params, batch):
    """The port's side: the same model on the port's parameter tree."""
    p = {f"{layer}.{leaf}": v for layer, leaves in params.items()
         for leaf, v in leaves.items()}
    return loss(CONFIG, p, batch)


def port_task(cfg: dict):
    from repro_torch.core.client import Task

    def init_params(key):
        tree = {}
        for name, shape in layout(cfg):
            layer, leaf = name.split(".")
            tree.setdefault(layer, {})[leaf] = torch.zeros(
                shape, device=key.device)
        return tree

    # looked up at each call, so that a test can plant a fault in it
    return Task(init_params, lambda params, batch: port_loss(params, batch))
