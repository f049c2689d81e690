"""Particle Swarm Optimization (FedPSO baseline, Park et al. 2021)."""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.metaheuristics.base import (Metaheuristic, init_population,
                                             take)


def pso(w: float = 0.7, c1: float = 1.4, c2: float = 1.4,
        vmax: float = 0.1) -> Metaheuristic:

    def init(key, x0, pop, fit_fn):
        s = init_population(key, x0, pop, fit_fn)
        gi = torch.argmin(s["fit"])
        s.update({
            "vel": torch.zeros_like(s["pop"]),
            "pbest": s["pop"], "pbest_fit": s["fit"],
            "gbest": take(s["pop"], gi), "gbest_fit": take(s["fit"], gi),
        })
        return s

    def step(key, state, fit_fn):
        r1k, r2k = random.split(key)
        pop, vel = state["pop"], state["vel"]
        P, D = pop.shape
        r1 = random.uniform(r1k, (P, D), pop.dtype)
        r2 = random.uniform(r2k, (P, D), pop.dtype)
        vel = (w * vel + c1 * r1 * (state["pbest"] - pop)
               + c2 * r2 * (state["gbest"][None] - pop))
        scale = torch.abs(pop) + 1e-3
        vel = torch.clamp(vel, -vmax * scale, vmax * scale)
        pop = pop + vel
        fit = fit_fn(pop)
        better = fit < state["pbest_fit"]
        pbest = torch.where(better[:, None], pop, state["pbest"])
        pbest_fit = torch.where(better, fit, state["pbest_fit"])
        gi = torch.argmin(pbest_fit)
        return {"pop": pop, "fit": fit, "vel": vel, "pbest": pbest,
                "pbest_fit": pbest_fit, "gbest": take(pbest, gi),
                "gbest_fit": take(pbest_fit, gi), "t": state["t"] + 1}

    return Metaheuristic("pso", init, step)
