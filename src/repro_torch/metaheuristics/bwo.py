"""Black Widow Optimization (Hayyolalam & Kazem 2020), FedBWO variant.

The paper (§III-C) *reorders* the canonical BWO for FL: each generation
runs **mutation -> procreation -> cannibalism** (instead of mating first),
then clients report only the best fitness.

Two routes, two algorithms, each held against its own reference:

* the composed step (``use_kernel=False``, the default) mutates every
  member with sparse Gaussian noise, then crosses ranked parents with a
  uniform alpha; the generation key splits six ways;
* the kernel step (``use_kernel=True``, the counterpart of the
  reference's ``use_pallas``) hands the whole generation key to
  ``repro_torch.kernels.bwo_evolve``, which splits it five ways and
  mutates only the first parent, with bit-derived noise.
"""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.metaheuristics.base import (Metaheuristic, init_population,
                                             select_best)


def bwo(pm: float = 0.4, pc: float = 0.44, pm_gene: float = 0.1,
        mut_scale: float = 0.05, procreate_frac: float = 0.6,
        use_kernel: bool = False) -> Metaheuristic:
    """pm: per-individual mutation prob; pc: cannibalism rate (fraction of
    offspring eliminated); procreate_frac: fraction of pop used as parents.
    """

    def init(key, x0, pop, fit_fn):
        return init_population(key, x0, pop, fit_fn)

    def step(key, state, fit_fn):
        pop, fit = state["pop"], state["fit"]
        P, D = pop.shape

        if use_kernel:
            from repro_torch.kernels.bwo_evolve import ops as bwo_ops
            children = bwo_ops.bwo_evolve(
                pop, fit, key, pm=pm, pm_gene=pm_gene, mut_scale=mut_scale,
                procreate_frac=procreate_frac)
        else:
            r_mut, r_sel, r_sel2, r_alpha, r_mask, r_noise = random.split(key, 6)
            # ---- 1. mutation (sparse Gaussian, per-individual gated) ----
            mut_ind = random.bernoulli(r_mut, pm, (P, 1))
            mut_gene = random.bernoulli(r_mask, pm_gene, (P, D))
            noise = random.normal(r_noise, (P, D), pop.dtype) * mut_scale
            noise = noise * (torch.abs(pop) + 1e-3)
            mutated = pop + noise * (mut_ind & mut_gene)

            # ---- 2. procreation: alpha-crossover among the fittest ----
            n_par = max(2, int(P * procreate_frac))
            order = torch.argsort(fit, stable=True)
            ranked = mutated[order]
            p1 = ranked[random.randint(r_sel, (P,), 0, n_par).long()]
            p2 = ranked[random.randint(r_sel2, (P,), 0, n_par).long()]
            alpha = random.uniform(r_alpha, (P, D), pop.dtype)
            children = alpha * p1 + (1 - alpha) * p2

        child_fit = fit_fn(children)

        # ---- 3. cannibalism: drop the worst pc of offspring, then keep
        #         the best P of (parents + survivors) ----
        n_surv = max(1, int(P * (1 - pc)))
        surv, surv_fit = select_best(children, child_fit, n_surv)
        all_pop = torch.cat([pop, surv], 0)
        all_fit = torch.cat([fit, surv_fit], 0)
        new_pop, new_fit = select_best(all_pop, all_fit, P)
        return {"pop": new_pop, "fit": new_fit, "t": state["t"] + 1}

    return Metaheuristic("bwo", init, step)
