"""The system under test: the port's federated rounds (``repro_torch``),
built from a configuration, a traffic mix and the benchmark's own inputs.

The port receives only what the benchmark made: its task wraps the port's
own loss (``bench/ports/<model>.py``) and hands out the benchmark's initial
weights; the clients' data and the evaluation data go in through
``build_experiment``'s hooks.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from bench.data import Inputs


def port_task(cfg: dict):
    """The port's task for the configuration: ``port_task(cfg)`` of
    ``bench/ports/<model>.py``."""
    return importlib.import_module(f"bench.ports.{cfg['model']}") \
        .port_task(cfg)


def weights_tree(task, layout: list, flat: torch.Tensor):
    """The benchmark's flat weights in the port's parameter tree.  The
    port's leaves, in its ravel order, must be the layout's leaves: same
    names, same shapes; otherwise the genome orders differ and this
    raises."""
    from repro_torch import random, tree
    template = task.init_params(random.PRNGKey(0, "meta"))
    paths = [p.strip("/").replace("/", ".") for p in tree.paths(template)]
    shapes = [tuple(l.shape) for l in tree.leaves(template)]
    want = [(n, tuple(s)) for n, s in layout]
    if list(zip(paths, shapes)) != want:
        raise ValueError(f"the port's parameter leaves {list(zip(paths, shapes))}"
                         f" are not the configuration's {want}")
    parts = torch.split(flat, [math.prod(s) for s in shapes])
    return tree.unflatten(tree.structure(template),
                          [p.reshape(s) for p, s in zip(parts, shapes)])


def build(cfg: dict, traffic: dict, seed: int, inputs: Inputs, layout: list,
          device: str, engine: str = "auto"):
    """``build_experiment`` at the traffic mix's settings, with the
    benchmark's task, weights and data.  ``engine`` is the traffic's
    ("auto": batched on the card); the CPU rehearsal asks for "batched"."""
    from repro_torch import tree
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.core.client import Task
    base = port_task(cfg)
    params = weights_tree(base, layout, inputs.weights)

    def init_params(key):
        return tree.map(torch.clone, params)

    fl = FLConfig(strategy=traffic["strategy"], task=cfg["task"],
                  n_clients=traffic["n_clients"],
                  client_ratio=traffic["client_ratio"],
                  partition=traffic["partition"],
                  n_train=traffic["n_train"], n_test=traffic["n_test"],
                  batch_size=traffic["batch_size"],
                  local_epochs=traffic["local_epochs"], lr=traffic["lr"],
                  mh_pop=traffic["mh_pop"],
                  mh_generations=traffic["mh_generations"], engine=engine,
                  rounds_per_dispatch=traffic["rounds_per_dispatch"],
                  pipeline_blocks=traffic["pipeline_blocks"],
                  eval_every=traffic["eval_every"],
                  max_rounds=traffic["max_rounds"],
                  patience=traffic["patience"], tau=traffic["tau"],
                  server_seed=int(seed), device=device,
                  bwo_kernel=traffic["bwo_kernel"])
    hp = dataclasses.replace(fl.client_hp(),
                             fitness_batches=traffic["fitness_batches"])
    return build_experiment(fl, task=Task(init_params, base.loss_fn),
                            client_data=inputs.clients,
                            eval_data=inputs.eval, hp=hp)


def flat_params(params) -> torch.Tensor:
    """A parameter tree as one flat vector in the genome order."""
    from repro_torch import tree
    return torch.cat([l.detach().reshape(-1) for l in tree.leaves(params)])


def bwo_launches() -> int:
    """The port's count of ``bwo_evolve`` launches (a replayed graph adds
    the launches it holds)."""
    from repro_torch.kernels.bwo_evolve import bwo_evolve
    return bwo_evolve.launches
