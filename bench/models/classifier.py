"""What the image classifiers (``cnn.py``, ``mlp.py``) share: their data
and their loss, in plain PyTorch.

The data is the CIFAR-like problem the port's own generator draws
(``data/synthetic.py::make_cifar_like``: a smooth random template a class,
normalised; an image is its template plus pixel noise, times a random
brightness), rewritten here: ``num_classes`` classes of ``image_size`` x
``image_size`` x ``channels`` images, float32, labels int32.  The loss is
the mean negative log-likelihood of the labels, and the accuracy.
"""
from __future__ import annotations

import torch


def _smooth(x, passes: int = 3):
    for _ in range(passes):
        x = (x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
             + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)) / 5.0
    return x


def cifar_like(gen, n_train: int, n_test: int, image_size: int,
               channels: int, num_classes: int, device,
               noise: float = 0.35):
    """``(train, test)``: dicts of ``images (n, H, W, C)`` and ``labels
    (n,)``, drawn from ``gen`` in this order: the templates, then the
    training set, then the test set."""
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


def make_data(cfg: dict, n_train: int, n_test: int, gen, device):
    """The configuration's CIFAR-like train and test sets."""
    return cifar_like(gen, n_train, n_test, cfg["image_size"],
                      cfg["channels"], cfg["num_classes"], device)


def cross_entropy(logits, labels):
    """Mean negative log-likelihood of ``labels`` under ``logits`` (classes
    on the last axis), and the accuracy, in the logits' precision."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None]).mean()
    acc = (logits.argmax(-1) == labels).to(logits.dtype).mean()
    return nll, acc
