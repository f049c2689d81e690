"""Grey Wolf Optimizer (FedGWO baseline, Abasi et al. 2022)."""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.metaheuristics.base import (Metaheuristic, init_population,
                                             keep_incumbent, take)


def gwo(max_iter: int = 20, step_scale: float = 0.1) -> Metaheuristic:
    """``step_scale`` bounds the hunt step relative to weight magnitude —
    NN weights need far smaller moves than GWO's canonical box search."""

    def init(key, x0, pop, fit_fn):
        return init_population(key, x0, pop, fit_fn)

    def step(key, state, fit_fn):
        pop, fit = state["pop"], state["fit"]
        P, D = pop.shape
        t = state["t"].to(torch.float32)
        a = torch.clamp_min(2.0 * (1.0 - t / max_iter), 0.0)
        order = torch.argsort(fit, stable=True)
        # a population under 3 repeats its last member, as the
        # reference's clamped indexing does
        alpha, beta, delta = (take(pop, order[min(i, P - 1)])
                              for i in range(3))

        def hunt(k, leader):
            k1, k2 = random.split(k)
            r1 = random.uniform(k1, (P, D), pop.dtype)
            r2 = random.uniform(k2, (P, D), pop.dtype)
            A = 2 * a * r1 - a
            C = 2 * r2
            dist = torch.abs(C * leader[None] - pop)
            move = A * dist
            bound = step_scale * (torch.abs(leader)[None] + 1e-3)
            return leader[None] - torch.clamp(move, -bound, bound)

        k1, k2, k3 = random.split(key, 3)
        new_pop = (hunt(k1, alpha) + hunt(k2, beta) + hunt(k3, delta)) / 3.0
        new_pop, new_fit = keep_incumbent(pop, fit, new_pop, fit_fn(new_pop))
        return {"pop": new_pop, "fit": new_fit, "t": state["t"] + 1}

    return Metaheuristic("gwo", init, step)
