"""The threefry draws as one operator, ``repro_torch::threefry``: the kernel
for CUDA keys, the plain version for CPU keys (and nothing else).

The operator takes keys as (K, 2).  Its vmap rule folds the batch
dimensions, nested vmaps included, into K, so a draw under
``torch.func.vmap`` over clients is one launch for all of them.  The key is
never read on the host: a captured CUDA graph draws under whatever key its
buffer holds when it is replayed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.threefry import ref
from repro_torch.kernels.threefry.threefry import (DTYPES, out_shape,
                                                   threefry_cuda)


@torch.library.custom_op("repro_torch::threefry", mutates_args=())
def threefry(keys: torch.Tensor, start: int, n: int, kind: str, lo: float,
             hi: float, p: float) -> torch.Tensor:
    """The counters start..start+n-1 under each of the (K, 2) keys, as
    ``kind`` (``threefry.KINDS``): ``out_shape(K, n, kind)``."""
    if keys.device.type == "cuda":
        return threefry_cuda(keys, start, n, kind, lo=lo, hi=hi, p=p)
    if keys.device.type == "cpu":
        return ref.threefry_ref(keys, start, n, kind, lo=lo, hi=hi, p=p)
    raise ValueError(f"threefry runs on cuda or cpu, not {keys.device}")


@threefry.register_fake
def _threefry_fake(keys, start, n, kind, lo, hi, p):
    return keys.new_empty(out_shape(keys.shape[0], n, kind),
                          dtype=DTYPES[kind])


@threefry.register_vmap
def _threefry_vmap(info, in_dims, keys, start, n, kind, lo, hi, p):
    """B batches of K keys as one draw of B*K keys."""
    if in_dims[0] is None:
        return threefry(keys, start, n, kind, lo, hi, p), None
    keys = keys.movedim(in_dims[0], 0)
    B, K = keys.shape[:2]
    out = threefry(keys.reshape(B * K, 2).contiguous(), start, n, kind, lo,
                   hi, p)
    return out.reshape(B, K, *out.shape[1:]), 0


def draw(key: torch.Tensor, start: int, n: int, kind: str, *,
         lo: float = 0.0, hi: float = 1.0, p: float = 0.0) -> torch.Tensor:
    """One (2,) key's counters start..start+n-1 as ``kind``: (n,), or
    (n, 2) for pairs."""
    if tuple(key.shape) != (2,):
        raise ValueError(f"a key is a (2,) tensor, got shape "
                         f"{tuple(key.shape)}")
    return threefry(key.to(torch.int64).reshape(1, 2), start, n, kind, lo,
                    hi, p)[0]
