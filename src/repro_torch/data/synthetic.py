"""Synthetic datasets, drawn from the same keys as the reference's, so a
seed gives the same labels and the same images (within float32 rounding),
and the same token streams exactly.

``make_cifar_like`` builds a *learnable* 10-class 32x32x3 image problem:
each class has a random smooth template; samples are the template plus
pixel noise and random brightness.  ``make_token_dataset`` draws Markov
token streams for the language models' train step.
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


def make_token_dataset(key, n_seqs: int, seq_len: int, vocab: int,
                       order: int = 2):
    """Synthetic Markov token streams (learnable LM data), on the key's
    device: each token is, with probability 0.7, the preferred successor
    ``pref[tok]`` of the one before, else uniform.  The reference draws
    every step's keys in a scan; none depends on a token, so here every key
    and every draw is made up front (threefry under ``vmap``) and only the
    gather ``pref[tok]`` walks the steps.  Returns tokens and labels (the
    next token, -1 at the end), (n_seqs, seq_len) int32."""
    rk, rs = random.split(key)
    pref = random.randint(rk, (vocab,), 0, vocab)
    vmap = torch.func.vmap
    seq_keys = random.split(rs, n_seqs)                       # (n, 2)
    k0, kseq = vmap(random.split)(seq_keys).unbind(1)
    t0 = vmap(lambda k: random.randint(k, (), 0, vocab))(k0)   # (n,)
    steps = vmap(lambda k: random.split(k, seq_len))(kseq).reshape(-1, 2)
    knext, kchoice = vmap(random.split)(steps).unbind(1)
    rand = vmap(lambda k: random.randint(k, (), 0, vocab))(kchoice)
    greedy = vmap(lambda k: random.uniform(k, ()))(knext) < torch.full(
        (), 0.7, dtype=torch.float32, device=key.device)
    rand = rand.reshape(n_seqs, seq_len)
    greedy = greedy.reshape(n_seqs, seq_len)
    toks = torch.empty((n_seqs, seq_len), dtype=torch.int32, device=key.device)
    tok = t0
    for t in range(seq_len):
        tok = torch.where(greedy[:, t], pref[tok.long()], rand[:, t])
        toks[:, t] = tok
    labels = torch.cat([toks[:, 1:], torch.full((n_seqs, 1), -1,
                                                dtype=torch.int32,
                                                device=key.device)], dim=1)
    return {"tokens": toks, "labels": labels}
