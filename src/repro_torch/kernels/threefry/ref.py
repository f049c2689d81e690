"""Plain PyTorch version of the threefry kernel: ``random.py``'s int64
route, key by key.  The CPU path of ``ops.threefry`` and the oracle the
CUDA kernel is held against (it runs on any device)."""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.kernels.threefry.threefry import DTYPES, out_shape


def draw_ref(key: torch.Tensor, start: int, n: int, kind: str, *,
             lo: float = 0.0, hi: float = 1.0,
             p: float = 0.0) -> torch.Tensor:
    """One (2,) key's counters start..start+n-1 as ``kind``, by int64 ops."""
    if kind == "pairs":
        y1, y2 = random._hash_iota(key, n, start)
        return torch.stack([y1, y2], dim=1)
    if kind == "bits":
        return random._i32(random._bits_at(key, start, n))
    lo_t = torch.full((), lo, dtype=torch.float32, device=key.device)
    hi_t = torch.full((), hi, dtype=torch.float32, device=key.device)
    u = random._uniform_at(key, start, n, lo_t, hi_t, True)
    if kind == "uniform":
        return u
    if kind == "normal":
        return random._normal_of(u)
    if kind == "bernoulli":
        return u < torch.full((), p, dtype=torch.float32, device=key.device)
    raise ValueError(f"unknown kind {kind!r}")


def threefry_ref(keys: torch.Tensor, start: int, n: int, kind: str, *,
                 lo: float = 0.0, hi: float = 1.0,
                 p: float = 0.0) -> torch.Tensor:
    """(K, 2) keys -> ``out_shape(K, n, kind)``: each key's draw."""
    if keys.shape[0] == 0:
        return torch.empty(out_shape(0, n, kind), dtype=DTYPES[kind],
                           device=keys.device)
    return torch.stack([draw_ref(k, start, n, kind, lo=lo, hi=hi, p=p)
                        for k in keys])
