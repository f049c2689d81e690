"""Mixture-of-Experts layer with capacity-based dispatch: the port of
``repro/models/moe.py``.

Routing is the reference's: float32 router logits, softmax, top-k, the
gates renormalised, a Switch load-balance loss; each (token, slot) pair
takes its position in its expert from a cumsum along its batch row (token-
major slot order), pairs past the capacity C are dropped, and the kept ones
are scattered into a (B, E, C, d) buffer that the experts multiply as three
batched products (cuBLAS here, XLA einsums in the reference), then gathered
back and summed under the gates.  DeepSeek-V2's shared experts and Arctic's
parallel dense FFN are added on top.  With S = 1 (decode) each expert
multiplies C = 8 slots, most of them empty: the reference's dense dispatch,
kept as it is.

On a mesh (``DTensor`` activations, as the dry run runs them) the dispatch
is expert-parallel, as the reference's ``shard_map`` branch: each rank
scatters its batch rows' pairs into the experts it holds (E / model of
them, where ``model`` divides E), so the (B, E, C, d) buffer is born
sharded over ``model``; the experts' products run on that shard, and the
combine gathers the buffer over ``model`` (the reference's default
all-gather combine) before each rank reads its rows' pairs back.  Both
run through ``local_map`` (:func:`repro_torch.sharding.context.local_dims`).
Without a mesh, ``moe_apply`` is the single-device code.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as nn
from repro_torch.sharding.context import (axes, batch_axes, constrain,
                                          is_dtensor, local_dims)


def moe_init(key, cfg: ArchConfig):
    """The reference's key schedule, split(key, 6); the router stays
    float32 whatever the model's dtype."""
    m = cfg.moe
    d = cfg.d_model
    dff = m.expert_d_ff or cfg.d_ff
    r = random.split(key, 6)
    dt = cfg.param_dtype
    E = m.num_experts
    p = {
        "router": {"w": nn._normal(r[0], (d, E), d ** -0.5, torch.float32)},
        "wi": nn._normal(r[1], (E, d, dff), d ** -0.5, dt),
        "wg": nn._normal(r[2], (E, d, dff), d ** -0.5, dt),
        "wo": nn._normal(r[3], (E, dff, d), dff ** -0.5, dt),
    }
    if m.num_shared_experts:
        p["shared"] = nn.ffn_init(r[4], "swiglu", d,
                                  dff * m.num_shared_experts, dtype=dt)
    if m.dense_residual:
        p["dense"] = nn.ffn_init(r[5], "swiglu", d, cfg.d_ff, dtype=dt)
    return p


class Routing(NamedTuple):
    """Where each of the B x S*K (token, slot) pairs goes."""
    gate: torch.Tensor      # (B, S, K) float32, renormalised
    eidx: torch.Tensor      # (B, S, K) int64 experts, by falling probability
    pos: torch.Tensor       # (B, S*K) position in its expert, before capping
    keep: torch.Tensor      # (B, S*K) bool: pos < capacity
    capacity: int           # C, slots per expert and batch row
    aux: torch.Tensor       # () float32 load-balance loss


def capacity(cfg: ArchConfig, S: int, capacity_factor: float = 1.25) -> int:
    """C = max(8, ceil-ish(cf * S*K / E)), rounded up to a multiple of 8,
    in the reference's Python float arithmetic."""
    m = cfg.moe
    C = max(8, int(capacity_factor * S * m.top_k / m.num_experts + 0.999))
    return -(-C // 8) * 8


def route(p, x, cfg: ArchConfig, *,
          capacity_factor: float = 1.25) -> Routing:
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    logits = x.float() @ p["router"]["w"]                         # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1, sorted=True)        # (B,S,K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean((0, 1))                                       # (E,)
    ce = F.one_hot(eidx, E).float().sum((0, 1, 2)) / (B * S * K)
    aux = E * torch.sum(me * ce) * m.router_aux_loss

    # per-row position in each expert: a cumsum, token-major slots
    e_flat = eidx.reshape(B, S * K)
    onehot = F.one_hot(e_flat, E)                                 # (B,SK,E)
    pos = torch.gather(onehot.cumsum(1) - 1, -1, e_flat[..., None])[..., 0]
    C = capacity(cfg, S, capacity_factor)
    return Routing(gate, eidx, pos, pos < C, C, aux)


def _rows(e, pos_c, E: int, C: int):
    """The flat row of a (B, E, C) buffer for each (row, pair)."""
    B = e.shape[0]
    return ((torch.arange(B, device=e.device)[:, None] * E + e) * C
            + pos_c).reshape(-1)


def _scatter(contrib, e_flat, pos_c, *, E: int, C: int,
             lo: Optional[int] = None):
    """(B, SK, d) contributions -> the (B, E, C, d) dispatch buffer.  A
    dropped pair adds zeros at C - 1, so each row holds at most one kept
    pair and the sum is exact in the contributions' dtype.  With ``lo``,
    the buffer of experts lo .. lo + E - 1 alone: a pair of another expert
    adds zeros."""
    B, _, d = contrib.shape
    if lo is not None:
        local = (e_flat >= lo) & (e_flat < lo + E)
        contrib = contrib * local[..., None].to(contrib.dtype)
        e_flat = (e_flat - lo).clamp(0, E - 1)
    return contrib.new_zeros((B * E * C, d)).index_add_(
        0, _rows(e_flat, pos_c, E, C), contrib.reshape(-1, d)).reshape(
            B, E, C, d)


def _gather(yb, e_flat, pos_c):
    """Each pair's row of the (B, E, C, d) buffer: (B, SK, d)."""
    B, E, C, d = yb.shape
    return yb.reshape(B * E * C, d)[_rows(e_flat, pos_c, E, C)].reshape(
        B, -1, d)


def _dispatch_ep(contrib, e_flat, pos_c, *, E: int, C: int):
    """The expert-parallel scatter on a mesh: each rank's batch rows into
    its own experts, the buffer sharded over ``model`` where it divides E
    (else each rank builds the whole buffer of its rows)."""
    mesh = contrib.device_mesh
    m = axes(mesh)
    n_model = m.size("model") if "model" in m.names else 1
    if n_model > 1 and E % n_model == 0:
        E_loc = E // n_model

        def scatter(c, e, pos):
            lo = mesh.get_local_rank("model") * E_loc
            return _scatter(c, e, pos, E=E_loc, C=C, lo=lo)
        # each rank's scatter reads only the pairs of its experts: the
        # contributions' gradient is a sum over the model ranks
        return local_dims(scatter, (contrib, "b..+m"), (e_flat, "b."),
                          (pos_c, "b."), out="bm..")
    return local_dims(lambda c, e, pos: _scatter(c, e, pos, E=E, C=C),
                      (contrib, "b.."), (e_flat, "b."), (pos_c, "b."),
                      out="b...")


def moe_apply(p, x, cfg: ArchConfig, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    rt = route(p, x, cfg, capacity_factor=capacity_factor)
    C = rt.capacity
    e_flat = rt.eidx.reshape(B, S * K)
    pos_c = rt.pos.clamp(max=C - 1)
    keep = rt.keep[..., None]
    contrib = x.repeat_interleave(K, dim=1) * keep.to(x.dtype)   # (B,SK,d)
    sharded = is_dtensor(x)
    if sharded:
        xb = constrain(_dispatch_ep(contrib, e_flat, pos_c, E=E, C=C),
                       batch_axes(), "model", None, None)
        wg, wi, wo = (constrain(p[n], "model", None, None)
                      for n in ("wg", "wi", "wo"))
    else:
        xb = _scatter(contrib, e_flat, pos_c, E=E, C=C)
        wg, wi, wo = p["wg"], p["wi"], p["wo"]

    # the experts' swiglu FFN
    h = (F.silu(torch.einsum("becd,edf->becf", xb, wg))
         * torch.einsum("becd,edf->becf", xb, wi))
    yb = torch.einsum("becf,efd->becd", h, wo)

    # gather back and combine the top-k
    if sharded:
        yb = constrain(yb, batch_axes(), None, None, None)
        y_slot = local_dims(_gather, (yb, "b..."), (e_flat, "b."),
                            (pos_c, "b."), out="b..")
    else:
        y_slot = _gather(yb, e_flat, pos_c)
    y_slot = y_slot * keep.to(yb.dtype)
    y = (y_slot.reshape(B, S, K, d)
         * rt.gate.to(yb.dtype)[..., None]).sum(2)                # (B,S,d)

    if m.num_shared_experts:
        y = y + nn.ffn_apply("swiglu", p["shared"], x)
    if m.dense_residual:
        y = y + nn.ffn_apply("swiglu", p["dense"], x)
    return y, rt.aux
