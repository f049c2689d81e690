"""Carrying parameters between the reference and the port, and the flat
genome BWO evolves.

The port keeps the reference's layouts, so carrying a tree across is a
copy: ``params_from_jax`` takes a nested dict of arrays (a JAX tree
through ``np.asarray``) and ``params_to_numpy`` gives one back.
``train_state_from_jax`` carries a train state (params, the optimizer's
moments, the step) the same way.  ``ravel_params`` matches
``jax.flatten_util.ravel_pytree``: leaves in
sorted-key order (``b`` before ``w``), each row-major, concatenated.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import tree


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart: carry the
        # bits across as int16 and reinterpret them
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes            # numpy's bfloat16, as JAX's arrays give
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree_of_numpy, device) -> dict:
    """A nested dict of arrays (float32, bfloat16, ints) as tensors on
    ``device``, bit for bit."""
    return tree.map(lambda a: _to_tensor(a, device), tree_of_numpy)


def params_to_numpy(params) -> dict:
    return tree.map(_to_numpy, params)


def train_state_from_jax(state, device) -> dict:
    """The reference's train state ``{"params", "opt", "step"}`` (arrays,
    or a tree of them through ``np.asarray``) as the port's, bit for bit on
    ``device``: the optimizer's state (AdamW's ``m`` and ``v``, SGD's
    ``mu`` or nothing) is a tree like the parameters, and the step a 0-dim
    int32 tensor."""
    return {"params": params_from_jax(state["params"], device),
            "opt": params_from_jax(state["opt"], device),
            "step": torch.as_tensor(np.array(state["step"]),
                                    dtype=torch.int32, device=device)}


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
