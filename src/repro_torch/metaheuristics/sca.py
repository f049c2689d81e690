"""Sine Cosine Algorithm (FedSCA baseline, Abasi et al. 2022)."""
from __future__ import annotations

import math

import torch

from repro_torch import random
from repro_torch.metaheuristics.base import (Metaheuristic, init_population,
                                             keep_incumbent, take)


def sca(a: float = 2.0, max_iter: int = 20,
        step_scale: float = 0.1) -> Metaheuristic:

    def init(key, x0, pop, fit_fn):
        return init_population(key, x0, pop, fit_fn)

    def step(key, state, fit_fn):
        pop, fit = state["pop"], state["fit"]
        P, D = pop.shape
        t = state["t"].to(torch.float32)
        r1 = a * torch.clamp_min(1.0 - t / max_iter, 0.0)
        best = take(pop, torch.argmin(fit))
        k2, k3, k4 = random.split(key, 3)
        r2 = random.uniform(k2, (P, D), pop.dtype) * 2 * math.pi
        r3 = random.uniform(k3, (P, D), pop.dtype) * 2
        r4 = random.uniform(k4, (P, D), pop.dtype)
        dist = torch.abs(r3 * best[None] - pop)
        move = torch.where(r4 < 0.5, r1 * torch.sin(r2) * dist,
                           r1 * torch.cos(r2) * dist)
        bound = step_scale * (torch.abs(pop) + 1e-3)
        new_pop = pop + torch.clamp(move, -bound, bound)
        new_pop, new_fit = keep_incumbent(pop, fit, new_pop, fit_fn(new_pop))
        return {"pop": new_pop, "fit": new_fit, "t": state["t"] + 1}

    return Metaheuristic("sca", init, step)
