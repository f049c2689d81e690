"""Population meta-heuristic interface.

A :class:`Metaheuristic` evolves a population of flat parameter vectors
``(P, D)`` against a batched fitness function ``fit_fn: (P, D) -> (P,)``
(lower is better).  The population lives on the key's device and each
generation is a handful of whole-population tensor ops.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch import random

FitFn = Callable[[torch.Tensor], torch.Tensor]
State = Dict[str, Any]


class Metaheuristic(NamedTuple):
    name: str
    init: Callable[[torch.Tensor, torch.Tensor, int, FitFn], State]
    step: Callable[[torch.Tensor, State, FitFn], State]


def init_population(key, x0: torch.Tensor, pop: int, fit_fn: FitFn,
                    spread: float = 0.02) -> State:
    """Seed a population around x0 (member 0 is x0 itself)."""
    noise = random.normal(key, (pop, x0.shape[0]), x0.dtype) * spread
    noise = noise * (torch.abs(x0)[None, :] + 1e-3)
    noise[0].zero_()
    population = x0[None, :] + noise
    return {"pop": population, "fit": fit_fn(population),
            "t": torch.zeros((), dtype=torch.int32, device=x0.device)}


def take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-dim index tensor, as a gather on the device.
    Indexing with a 0-dim tensor reads it on the host (a sync), which a
    CUDA graph capture refuses; under vmap, with ``i`` batched, both are
    the same gather."""
    return a.index_select(0, i.reshape(1))[0]


def best_member(state: State):
    i = torch.argmin(state["fit"])
    return take(state["pop"], i), take(state["fit"], i)


def select_best(pop, fit, n):
    idx = torch.argsort(fit, stable=True)[:n]
    return pop[idx], fit[idx]


def keep_incumbent(pop, fit, new_pop, new_fit):
    """Elitism: the new generation's worst member becomes the incumbent
    best (the reference's ``new_pop.at[worst].set(pop[best])``), written
    out of place, so it holds under vmap with a per-client ``worst``."""
    worst = torch.argmax(new_fit)
    best = torch.argmin(fit)
    at = torch.arange(new_fit.shape[0], device=new_fit.device) == worst
    return (torch.where(at[:, None], take(pop, best)[None], new_pop),
            torch.where(at, take(fit, best), new_fit))
