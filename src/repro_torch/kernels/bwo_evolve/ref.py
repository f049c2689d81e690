"""Plain PyTorch version of the fused BWO generation update: the CPU path
of ``ops.bwo_evolve`` and the oracle the CUDA kernel is held against.

Semantics (one generation, paper §III-C order mutation -> procreation):

  for each child row i:
    p1 = pop[p1_idx[i]]                     # fitter parent (pre-ranked)
    p2 = pop[p2_idx[i]]
    mask_i  = (bits2 & 0xff) < int(pm_gene*256)     # sparse gene mask
    u_noise = ((bits2 >> 8) & 0xffffff) / 2^24      # uniform in [0,1)
    noise   = (2*u_noise - 1) * mut_scale * (|p1| + 1e-3)
    p1m     = p1 + noise * mask_i * row_gate[i]     # 1. mutation
    alpha   = bits1 / 2^32                          # rounds to nearest
    child_i = alpha * p1m + (1 - alpha) * p2        # 2. procreation

Cannibalism (selection) happens outside on child fitness.
"""
from __future__ import annotations

import torch


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit words (an int32 view or int64 values) as int64."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def bwo_evolve_ref(pop, p1_idx, p2_idx, bits1, bits2, row_gate, *,
                   pm_gene: float, mut_scale: float):
    """pop (P, D); idx (P,) int; bits (P, Dp) 32-bit words with Dp >= D
    (columns past D are not read); row_gate (P, 1).  Returns (P, D) in
    pop's dtype."""
    D = pop.shape[1]
    b1, b2 = _u32(bits1[:, :D]), _u32(bits2[:, :D])
    p1 = pop[p1_idx.long()]
    p2 = pop[p2_idx.long()]
    thresh = int(pm_gene * 256)
    mask = ((b2 & 0xFF) < thresh).to(pop.dtype)
    u_noise = ((b2 >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / float(1 << 24))
    noise = (2.0 * u_noise - 1.0) * mut_scale * (torch.abs(p1) + 1e-3)
    p1m = p1 + noise.to(pop.dtype) * mask * row_gate
    alpha = b1.to(torch.float32) * (1.0 / 4294967296.0)
    alpha = alpha.to(pop.dtype)
    return alpha * p1m + (1.0 - alpha) * p2
