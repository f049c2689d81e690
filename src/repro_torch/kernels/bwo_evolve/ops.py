"""One BWO generation step: rank parents, draw the random bits, apply the
fused update — the kernel for a CUDA tensor, the plain version for a CPU
tensor.  Under ``torch.func.vmap`` over clients the draws batch as they
are (on the card one threefry launch for all clients' bit planes, drawn
as the int32 words the kernel reads) and the update is one
launch over all clients' rows (``evolve``'s vmap rule).

The draws reproduce the reference's (``repro/kernels/bwo_evolve/ops.py``)
key for key: the generation key splits five ways, and both bit planes are
drawn at the 128-padded shape (P, Dp), since the threefry counter is the
flat index and any other shape changes every bit.  Only the bits are
padded; the population is read unpadded.
"""
from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.kernels.bwo_evolve import ref as ref_lib
from repro_torch.kernels.bwo_evolve.bwo_evolve import bwo_evolve_cuda


def sample(pop, fit, key, *, pm: float, procreate_frac: float):
    """The generation's draws: (pop32, p1_idx, p2_idx, bits1, bits2, gate)."""
    P, D = pop.shape
    r_sel1, r_sel2, r_b1, r_b2, r_gate = random.split(key, 5)
    n_par = max(2, int(P * procreate_frac))
    order = torch.argsort(fit, stable=True)
    p1_idx = order[random.randint(r_sel1, (P,), 0, n_par).long()].to(torch.int32)
    p2_idx = order[random.randint(r_sel2, (P,), 0, n_par).long()].to(torch.int32)
    Dp = -(-D // 128) * 128
    bits1 = random.bits32(r_b1, (P, Dp))
    bits2 = random.bits32(r_b2, (P, Dp))
    gate = random.bernoulli(r_gate, pm, (P, 1)).to(torch.float32)
    pop32 = pop.to(torch.float32).contiguous()
    return pop32, p1_idx, p2_idx, bits1, bits2, gate


@torch.library.custom_op("repro_torch::bwo_evolve", mutates_args=())
def evolve(pop: torch.Tensor, p1_idx: torch.Tensor, p2_idx: torch.Tensor,
           bits1: torch.Tensor, bits2: torch.Tensor, row_gate: torch.Tensor,
           *, pm_gene: float, mut_scale: float) -> torch.Tensor:
    """The fused update on drawn inputs: the kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else).  An operator of its
    own, so that ``torch.func.vmap`` batches it by the rule below and not
    by a loop of launches."""
    if pop.device.type == "cuda":
        return bwo_evolve_cuda(pop, p1_idx, p2_idx, bits1, bits2, row_gate,
                               pm_gene=pm_gene, mut_scale=mut_scale)
    if pop.device.type == "cpu":
        return ref_lib.bwo_evolve_ref(pop, p1_idx, p2_idx, bits1, bits2,
                                      row_gate, pm_gene=pm_gene,
                                      mut_scale=mut_scale)
    raise ValueError(f"bwo_evolve runs on cuda or cpu, not {pop.device}")


@evolve.register_fake
def _evolve_fake(pop, p1_idx, p2_idx, bits1, bits2, row_gate, *, pm_gene,
                 mut_scale):
    return pop.new_empty(pop.shape)


@evolve.register_vmap
def _evolve_vmap(info, in_dims, pop, p1_idx, p2_idx, bits1, bits2, row_gate,
                 *, pm_gene, mut_scale):
    """C clients' generations as one update over C*P rows: each client's
    rows follow the one before, its parent indices are offset by c*P, and
    the kernel is launched once (its grid has a row of blocks per child
    row, so C*P is bounded by the grid; ``bwo_evolve_cuda`` checks it)."""
    C = info.batch_size

    def batched(t, d):
        return (t.unsqueeze(0).expand(C, *t.shape) if d is None
                else t.movedim(d, 0))

    pop, p1_idx, p2_idx, bits1, bits2, row_gate = (
        batched(t, d) for t, d in zip(
            (pop, p1_idx, p2_idx, bits1, bits2, row_gate), in_dims[:6]))
    P, D = pop.shape[1:]
    offset = (torch.arange(C, dtype=torch.int32, device=pop.device) * P)[:, None]
    out = evolve(pop.reshape(C * P, D).contiguous(),
                 (p1_idx + offset).reshape(C * P),
                 (p2_idx + offset).reshape(C * P),
                 bits1.reshape(C * P, -1).contiguous(),
                 bits2.reshape(C * P, -1).contiguous(),
                 row_gate.reshape(C * P, 1).contiguous(),
                 pm_gene=pm_gene, mut_scale=mut_scale)
    return out.reshape(C, P, D), 0


def bwo_evolve(pop, fit, key, *, pm: float = 0.4, pm_gene: float = 0.1,
               mut_scale: float = 0.05, procreate_frac: float = 0.6):
    """One BWO generation: (P, D) population -> (P, D) children in pop's
    dtype (the update runs in float32).  Selection/cannibalism is done by
    the caller on child fitness."""
    pop32, p1, p2, b1, b2, gate = sample(pop, fit, key, pm=pm,
                                         procreate_frac=procreate_frac)
    children = evolve(pop32, p1, p2, b1, b2, gate, pm_gene=pm_gene,
                      mut_scale=mut_scale)
    return children.to(pop.dtype)


def bwo_evolve_reference(pop, fit, key, *, pm: float = 0.4,
                         pm_gene: float = 0.1, mut_scale: float = 0.05,
                         procreate_frac: float = 0.6):
    """Same sampling path, plain PyTorch update on any device — the oracle
    for the kernel."""
    pop32, p1, p2, b1, b2, gate = sample(pop, fit, key, pm=pm,
                                         procreate_frac=procreate_frac)
    children = ref_lib.bwo_evolve_ref(pop32, p1, p2, b1, b2, gate,
                                      pm_gene=pm_gene, mut_scale=mut_scale)
    return children.to(pop.dtype)
