"""African Vultures Optimization (FedAVO baseline, Hossain & Imteaj
2023, arXiv:2305.01154) — continuous adaptation for NN weights.

Two best vultures lead; each member follows one (probabilistically),
with exploration (random walk around the leader) early and exploitation
(spiral/levy-like approach) late.  Move sizes are *relative* to weight
magnitude like the other heuristics in this package."""
from __future__ import annotations

import math

import torch

from repro_torch import random
from repro_torch.metaheuristics.base import (Metaheuristic, init_population,
                                             keep_incumbent, take)


def avo(max_iter: int = 20, step_scale: float = 0.1,
        p1: float = 0.6) -> Metaheuristic:

    def init(key, x0, pop, fit_fn):
        return init_population(key, x0, pop, fit_fn)

    def step(key, state, fit_fn):
        pop, fit = state["pop"], state["fit"]
        P, D = pop.shape
        t = state["t"].to(torch.float32)
        # exploration-exploitation schedule (paper's F factor, simplified)
        F = (2.0 * torch.cos(math.pi / 2 * t / max_iter) + 1.0) \
            * (1.0 - t / max_iter)
        order = torch.argsort(fit, stable=True)
        # one member leads twice, as the reference's clamped indexing does
        best1, best2 = take(pop, order[0]), take(pop, order[min(1, P - 1)])

        k1, k2, k3, k4, k5 = random.split(key, 5)
        pick1 = random.bernoulli(k1, p1, (P, 1))
        leader = torch.where(pick1, best1[None], best2[None])

        r = random.uniform(k2, (P, D), pop.dtype)
        walk = (2.0 * r - 1.0) * F                       # exploration
        spiral = (random.uniform(k3, (P, D), pop.dtype)
                  * torch.cos(2 * math.pi
                              * random.uniform(k4, (P, D), pop.dtype))
                  * torch.abs(F))                         # exploitation
        move = torch.where(torch.abs(F) >= 1.0, walk, spiral) \
            * torch.abs(leader - pop)
        bound = step_scale * (torch.abs(leader) + 1e-3)
        new_pop = leader - torch.clamp(move, -bound, bound) \
            * torch.sign(leader - pop + 1e-12)
        new_pop, new_fit = keep_incumbent(pop, fit, new_pop, fit_fn(new_pop))
        return {"pop": new_pop, "fit": new_fit, "t": state["t"] + 1}

    return Metaheuristic("avo", init, step)
