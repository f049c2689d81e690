"""Optimizers over the port's parameter trees: the port of
``repro/optim/optimizers.py`` (SGD with and without momentum, AdamW with
b2 0.95), with moments in float32 whatever the parameters' type.

The arithmetic is the reference's, leaf by leaf.  ``update`` returns the
reference's (updates, state) pair and ``apply_updates`` adds them, as the
reference's API does.  The train step calls ``update_`` instead, which
updates every parameter and the moments in place, one leaf at a time: the
reference's tree-at-a-time temporaries (m, v, mhat, vhat and the updates)
would be five float32 trees at once, ~54 GB at 2.7 G parameters, and
in-place updates are the port's counterpart of the reference donating its
train state (``donate_argnums=(0,)``).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch import tree

LR = Union[Callable[[Any], torch.Tensor], float]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, step) -> (updates, new state)
    update: Callable[[Any, Any, Any, Any], tuple]
    # (params, grads, state, step) -> None: params and state in place
    update_: Callable[[Any, Any, Any, Any], None]


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scales every leaf of ``grads`` in place (in float32, stored back in
    its dtype) so their global norm is at most ``max_norm``; returns the
    norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree.leaves(grads):
        g.copy_(g.float() * scale)
    return norm


def clip_by_global_norm(grads, max_norm: float):
    """(the clipped tree, the norm before clipping), as the reference's."""
    clipped = tree.map(torch.clone, grads)
    return clipped, clip_by_global_norm_(clipped, max_norm)


def _make(lr: LR, init, leaf_update, state_keys) -> Optimizer:
    """An Optimizer from ``leaf_update(g32, moments, p, step, lrv) -> u``,
    which updates the leaf's moments (float32 tensors, in the order of
    ``state_keys``) in place and returns its float32 update."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def per_leaf(grads, state, params):
        """(g, the leaf's moments, p) for every leaf."""
        moments = (zip(*[tree.leaves(state[k]) for k in state_keys])
                   if state_keys else itertools.repeat(()))
        return zip(tree.leaves(grads), moments, tree.leaves(params))

    def update(grads, state, params, step):
        new = tree.map(torch.clone, state)
        lrv = lr_fn(step)
        ups = [leaf_update(g.float(), list(m), p, step, lrv)
               for g, m, p in per_leaf(grads, new, params)]
        return tree.unflatten(tree.structure(grads), ups), new

    @torch.no_grad()
    def update_(params, grads, state, step):
        lrv = lr_fn(step)
        for g, m, p in per_leaf(grads, state, params):
            p.copy_(p.float() + leaf_update(g.float(), list(m), p, step, lrv))

    return Optimizer(init, update, update_)


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree.map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)}

    def leaf_update(g, mom, p, step, lrv):
        if momentum == 0.0:
            return -lrv * g
        mu, = mom
        mu.mul_(momentum).add_(g)
        return -lrv * mu

    return _make(lr, init, leaf_update,
                 () if momentum == 0.0 else ("mu",))


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree.map(zeros, params), "v": tree.map(zeros, params)}

    def leaf_update(g, mom, p, step, lrv):
        m, v = mom
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return -lrv * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.float())

    return _make(lr, init, leaf_update, ("m", "v"))


def apply_updates(params, updates):
    return tree.map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
