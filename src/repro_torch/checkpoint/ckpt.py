"""Tree checkpointing to ``.npz``: the port of ``repro/checkpoint/ckpt.py``
in its file layout, so a checkpoint of either package restores in the
other.

Leaves are flattened to ``path -> array`` entries, the path's keys joined
by ``::`` in the trees' sorted-key order; the structure comes from the
template on restore, each leaf cast to the template leaf's type and put
on its device.  bfloat16 leaves are stored as numpy stores the reference's
bfloat16 arrays: 2-byte raw records (dtype ``|V2``), restored bit for bit
without ``ml_dtypes``.  Writes are atomic (a tmp file, then a rename) and
a ``latest`` marker names the newest step.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

_SEP = "::"
_RAW_BF16 = np.dtype("V2")


def _flatten(node, prefix=()) -> dict:
    if isinstance(node, dict):
        flat = {}
        for k in sorted(node):
            flat.update(_flatten(node[k], prefix + (str(k),)))
        return flat
    return {_SEP.join(prefix): node}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.array(a)                   # a writable copy, 0-dim kept
    if a.dtype == _RAW_BF16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(str(step))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "latest")
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", fn))] \
        if os.path.isdir(ckpt_dir) else []
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """A tree shaped as ``template`` (a nested dict of tensors) from the
    checkpoint of ``step`` (the latest by default)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return _restore(data, template, ())


def _restore(data, node, prefix):
    if isinstance(node, dict):
        return {k: _restore(data, node[k], prefix + (str(k),))
                for k in sorted(node)}
    key = _SEP.join(prefix)
    arr = data[key]
    if tuple(arr.shape) != tuple(node.shape):
        raise ValueError(f"{key}: the checkpoint holds {arr.shape}, the "
                         f"template {tuple(node.shape)}")
    return _to_tensor(arr, node)
