"""FL client: local SGD epochs + (FedX) meta-heuristic weight refinement.

``make_update`` returns ``update(params, data, mask, key) -> (score,
params)``: SGD over the client's batches for a few epochs, then G
generations of the meta-heuristic on the flattened weights with fitness =
loss on the client's own data (paper Algorithm 3, UpdateClient).  The key
schedule is the reference's, split for split, so a client draws the same
dropout masks and the same BWO randomness.  The same update serves both
round engines: called once per client (sequential), or once for all
clients under ``torch.func.vmap`` (batched, ``repro_torch.core.engine``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import random, spans, tree
from repro_torch.convert import ravel_params
from repro_torch.metaheuristics import Metaheuristic
from repro_torch.metaheuristics.base import best_member


class Task(NamedTuple):
    """A trainable task: loss_fn(params, batch) -> (loss, acc)."""
    init_params: Callable[[torch.Tensor], Any]
    loss_fn: Callable[[Any, Any], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ClientHP:
    """The reference's ``ClientHP`` less ``unroll`` (an XLA-only knob: the
    port's loops are Python loops) and the unused ``momentum``."""
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
    # How the batched round engine (repro_torch.core.engine) traverses
    # the client axis: "vmap" | "scan" | "unroll" | "auto" (scan on the
    # CPU, vmap on the card); see engine.resolve_vectorize.
    vectorize: str = "auto"


def make_local_sgd(task: Task, hp: ClientHP):
    """``local_sgd(params, data, key, mask=None)``; data: dict of tensors
    with leading (n_batches, batch, ...) dims.

    Each step is functional (``torch.func.grad`` of the loss in the
    parameters), so the same code runs per client and under
    ``torch.func.vmap`` over the client axis.  ``mask``, an
    ``(n_batches,)`` bool row, marks the valid (non-padded) batches of a
    padded dataset: the update of a padded batch is discarded with
    ``torch.where``, and the key carry only advances past valid batches,
    so the per-batch dropout keys match the same client's unpadded run.
    """

    def objective(params, batch, dkey, anchor):
        loss = task.loss_fn(params, {**batch, "rng": dkey})[0]
        if hp.prox_mu > 0 and anchor is not None:   # FedProx
            sq = sum(torch.sum(torch.square(a.float() - b.float()))
                     for a, b in zip(tree.leaves(params),
                                     tree.leaves(anchor)))
            loss = loss + 0.5 * hp.prox_mu * sq
        return loss

    grad_fn = torch.func.grad(objective)

    def one_step(params, batch, dkey, anchor):
        grads = grad_fn(params, batch, dkey, anchor)
        return tree.map(lambda p, g: p - hp.lr * g.to(p.dtype),
                        params, grads)

    def sgd_epoch(params, data, key, anchor, mask):
        n_batches = tree.leaves(data)[0].shape[0]
        for i in range(n_batches):
            key2, dkey = random.split(key)
            new = one_step(params, tree.map(lambda a: a[i], data), dkey,
                           anchor)
            if mask is not None:
                valid = mask[i]
                new = tree.map(lambda n, p: torch.where(valid, n, p),
                               new, params)
                key2 = torch.where(valid, key2, key)
            params, key = new, key2
        return params

    def local_sgd(params, data, key, mask=None):
        anchor = params if hp.prox_mu > 0 else None   # w_global (FedProx)
        for _ in range(hp.local_epochs):
            key, ekey = random.split(key)
            params = sgd_epoch(params, data, ekey, anchor, mask)
        return params

    return local_sgd


def _fitness_slice(data, n_batches: int, n_valid=None):
    """The first ``n_batches`` batches of a client dataset, as a list.  A
    client with fewer batches repeats its last one, as the reference's
    clamped indexing does.  For a padded dataset (``n_valid``, the count
    of valid leading batches, a tensor) the gather is at
    ``min(i, n_valid - 1)``, so a short client scores the same repeated
    batch as on the sequential engine, never a padded zero batch."""
    if n_valid is None:
        n = tree.leaves(data)[0].shape[0]
        return [tree.map(lambda a: a[min(i, n - 1)], data)
                for i in range(n_batches)]
    idx = torch.minimum(
        torch.arange(n_batches, device=n_valid.device),
        torch.clamp_min(n_valid - 1, 0))
    sub = tree.map(lambda a: a[idx], data)
    return [tree.map(lambda a: a[i], sub) for i in range(n_batches)]


def make_fitness_fn(task: Task, data, unravel, n_batches: int,
                    n_valid=None):
    """Batched population fitness: mean loss over the first n_batches,
    one member at a time (as the reference maps over the population).
    ``n_valid`` marks the valid-batch count of a padded dataset (see
    :func:`_fitness_slice`)."""
    batches = _fitness_slice(data, n_batches, n_valid)
    samples = sum(tree.leaves(b)[0].shape[0] for b in batches)

    def one(flat):
        params = unravel(flat)
        losses = [task.loss_fn(params, b)[0] for b in batches]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def fit_fn(pops):
        # a "fitness" span counting the samples forwarded
        with spans.span("fitness", pops.shape[0] * samples):
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


def make_update(task: Task, hp: ClientHP,
                mh: Optional[Metaheuristic] = None):
    """Returns ``update(params, data, mask, key) -> (score, params)``, the
    one client update of both round engines.  With ``mh`` (FedX): SGD
    then meta-heuristic refinement; without (FedAvg): plain SGD, score =
    post-training loss.

    ``mask`` is None for a client's own batches, or the ``(n_batches,)``
    bool validity row of one client of a pad+mask stack
    (:func:`repro_torch.core.engine.stack_clients` with ``pad=True``):
    padded batches contribute no SGD step and no fitness term, so scores
    and weights match the same client's unpadded run.

    Nothing here reads a tensor on the host, so the update runs as it is
    under ``torch.func.vmap`` over the client axis (the batched engine).
    """
    local_sgd = make_local_sgd(task, hp)

    def update(global_params, data, mask, key):
        r_sgd, r_mh = random.split(key)
        # an "sgd" span counting the samples trained
        lead = tree.leaves(data)[0].shape[:2]
        with spans.span("sgd", hp.local_epochs * math.prod(lead)):
            params = local_sgd(global_params, data, r_sgd, mask)
        n_valid = None if mask is None else mask.to(torch.int64).sum()

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
                                     hp.fitness_batches, n_valid)
            if mh is None:
                return fit_fn(x0[None])[0], params
            state = mh.init(r_mh, x0, hp.mh_pop, fit_fn)
            rng = r_mh
            for _ in range(hp.mh_generations):
                rng, k = random.split(rng)
                state = mh.step(k, state, fit_fn)
            best, best_fit = best_member(state)
            return best_fit, to_params(best)

    return update


def make_client_update(task: Task, hp: ClientHP,
                       mh: Optional[Metaheuristic] = None,
                       masked: bool = False):
    """:func:`make_update` under the reference's signatures:
    ``client_update(params, data, key)``, or with ``masked=True``
    ``client_update(params, data, mask, key)``."""
    update = make_update(task, hp, mh)
    if masked:
        return update
    return lambda params, data, key: update(params, data, None, key)
