"""Carrying parameters between the reference and the port, and the flat
genome BWO evolves.

The port keeps the reference's layouts, so carrying a tree across is a
copy: ``params_from_jax`` takes a nested dict of arrays (a JAX tree
through ``np.asarray``) and ``params_to_numpy`` gives one back.
``ravel_params`` matches ``jax.flatten_util.ravel_pytree``: leaves in
sorted-key order (``b`` before ``w``), each row-major, concatenated.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import tree


def params_from_jax(tree_of_numpy, device) -> dict:
    return tree.map(lambda a: torch.as_tensor(np.array(a), device=device),
                    tree_of_numpy)


def params_to_numpy(params) -> dict:
    return tree.map(lambda t: t.detach().cpu().numpy(), params)


def ravel_params(params) -> Tuple[torch.Tensor, Callable]:
    """(flat, unravel) as ``ravel_pytree`` returns them; ``unravel(flat)``
    gives views into ``flat``."""
    leaves = tree.leaves(params)
    treedef = tree.structure(params)
    shapes = [tuple(l.shape) for l in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([l.reshape(-1) for l in leaves])

    def unravel(vec):
        parts = torch.split(vec, sizes)
        return tree.unflatten(treedef, [p.reshape(s)
                                        for p, s in zip(parts, shapes)])

    return flat, unravel
