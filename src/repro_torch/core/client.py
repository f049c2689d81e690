"""FL client: local SGD epochs + (FedX) meta-heuristic weight refinement.

``make_client_update`` returns ``client_update(params, data, key) ->
(score, params)``: SGD over the client's batches for a few epochs, then G
generations of the meta-heuristic on the flattened weights with fitness =
loss on the client's own data (paper Algorithm 3, UpdateClient).  The key
schedule is the reference's, split for split, so a client draws the same
dropout masks and the same BWO randomness.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import random, tree
from repro_torch.convert import ravel_params
from repro_torch.metaheuristics import Metaheuristic
from repro_torch.metaheuristics.base import best_member


class Task(NamedTuple):
    """A trainable task: loss_fn(params, batch) -> (loss, acc)."""
    init_params: Callable[[torch.Tensor], Any]
    loss_fn: Callable[[Any, Any], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ClientHP:
    """The reference's ``ClientHP`` less its XLA-only knobs (``unroll``,
    ``vectorize``) and the unused ``momentum``: the port's loops are
    Python loops, and it has no batched engine yet."""
    local_epochs: int = 5
    lr: float = 0.0025                  # paper §IV-A
    mh_pop: int = 8
    mh_generations: int = 5
    fitness_batches: int = 2
    # Beyond-paper: evolve one multiplicative gain per parameter tensor
    # instead of the raw weight vector (dim = #leaves, not #params).
    subspace: bool = False
    subspace_scale: float = 0.05
    # FedProx proximal term (Li et al. 2020): local objective +=
    # (mu/2) * ||w - w_global||^2.  0 disables.
    prox_mu: float = 0.0


def make_local_sgd(task: Task, hp: ClientHP, masked: bool = False):
    """data: dict of tensors with leading (n_batches, batch, ...) dims.

    ``masked=True`` (pad+mask batches of the batched engine) is not
    ported yet: ROADMAP.md, queue 1, item 8.
    """
    if masked:
        raise NotImplementedError(
            "masked local SGD belongs to the batched engine, not yet ported "
            "(ROADMAP.md, queue 1, item 8)")

    def one_step(params, batch, dkey, anchor=None):
        ps = tree.map(lambda p: p.detach().requires_grad_(True), params)
        loss = task.loss_fn(ps, {**batch, "rng": dkey})[0]
        if hp.prox_mu > 0 and anchor is not None:   # FedProx
            sq = sum(torch.sum(torch.square(a.float() - b.float()))
                     for a, b in zip(tree.leaves(ps), tree.leaves(anchor)))
            loss = loss + 0.5 * hp.prox_mu * sq
        grads = torch.autograd.grad(loss, tree.leaves(ps))
        return tree.unflatten(
            tree.structure(params),
            [p.detach() - hp.lr * g.to(p.dtype)
             for p, g in zip(tree.leaves(ps), grads)])

    def sgd_epoch(params, data, key, anchor):
        n_batches = tree.leaves(data)[0].shape[0]
        for i in range(n_batches):
            key, dkey = random.split(key)
            batch = tree.map(lambda a: a[i], data)
            params = one_step(params, batch, dkey, anchor)
        return params

    def local_sgd(params, data, key):
        anchor = params if hp.prox_mu > 0 else None   # w_global (FedProx)
        for _ in range(hp.local_epochs):
            key, ekey = random.split(key)
            params = sgd_epoch(params, data, ekey, anchor)
        return params

    return local_sgd


def _fitness_slice(data, n_batches: int):
    """The first ``n_batches`` batches of a client dataset, as a list.  A
    client with fewer batches repeats its last one, as the reference's
    clamped indexing does.  (The gather over padded datasets belongs to
    the batched engine, not yet ported.)"""
    n = tree.leaves(data)[0].shape[0]
    return [tree.map(lambda a: a[min(i, n - 1)], data)
            for i in range(n_batches)]


def make_fitness_fn(task: Task, data, unravel, n_batches: int):
    """Batched population fitness: mean loss over the first n_batches,
    one member at a time (as the reference maps over the population)."""
    batches = _fitness_slice(data, n_batches)

    def one(flat):
        params = unravel(flat)
        losses = [task.loss_fn(params, b)[0] for b in batches]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def fit_fn(pops):
        return torch.stack([one(pops[i]) for i in range(pops.shape[0])])

    return fit_fn


def make_subspace_map(params, scale: float):
    """Genome z (one gain per tensor) -> params * (1 + scale * (z - 1)).

    The genome is centered at 1.0 (identity map) so the meta-heuristics'
    *relative* move scales apply directly to z."""
    leaves = tree.leaves(params)
    treedef = tree.structure(params)

    def apply_z(z):
        scaled = [leaf * (1.0 + scale * (z[i] - 1.0)).to(leaf.dtype)
                  for i, leaf in enumerate(leaves)]
        return tree.unflatten(treedef, scaled)

    return len(leaves), apply_z


def make_client_update(task: Task, hp: ClientHP,
                       mh: Optional[Metaheuristic] = None,
                       masked: bool = False):
    """Returns ``client_update(params, data, key) -> (score, params)``.
    With ``mh`` (FedX): SGD then meta-heuristic refinement; without
    (FedAvg): plain SGD, score = post-training loss.  ``masked=True``
    raises: it belongs to the batched engine (ROADMAP.md, queue 1, item 8).
    """
    local_sgd = make_local_sgd(task, hp, masked=masked)

    def client_update(global_params, data, key):
        r_sgd, r_mh = random.split(key)
        params = local_sgd(global_params, data, r_sgd)

        with torch.no_grad():
            if hp.subspace and mh is not None:
                # the genome is one gain per tensor, mapped to params by
                # apply_z as a flat vector is by unravel
                n_genes, to_params = make_subspace_map(params,
                                                       hp.subspace_scale)
                x0 = torch.ones((n_genes,), device=key.device)
            else:
                x0, to_params = ravel_params(params)
            fit_fn = make_fitness_fn(task, data, to_params,
                                     hp.fitness_batches)
            if mh is None:
                return fit_fn(x0[None])[0], params
            state = mh.init(r_mh, x0, hp.mh_pop, fit_fn)
            rng = r_mh
            for _ in range(hp.mh_generations):
                rng, k = random.split(rng)
                state = mh.step(k, state, fit_fn)
            best, best_fit = best_member(state)
            return best_fit, to_params(best)

    return client_update
