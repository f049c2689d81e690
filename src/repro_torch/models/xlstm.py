"""xLSTM blocks, mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential): the port of ``repro/models/xlstm.py``
[arXiv:2405.04517].

Plain PyTorch on every device: the reference has no kernel here.  The
mLSTM's train and prefill run the reference's log-space-stabilised
chunkwise form (intra-chunk (c x c) products, the (dh x dh) state carried
across chunks by a loop); decode runs one step of the recurrence.  The
sLSTM runs its recurrence step by step, one step launched from the host
per token.  Gate pre-activations and states are float32.  In train mode
with grad on, each chunk runs under ``torch.utils.checkpoint``, as the
reference ``jax.checkpoint``s it.

A state is a dict of views into the model's cache (see
``transformer.Model.apply``): prefill (with a state) and decode write the
new state into it in place, as ``ssm.mamba_apply`` does.

On a mesh (the dry run's ``DTensor``s) both recurrences run shard by
shard through ``local_dims``: the mLSTM on each rank's rows and heads (a
decode step on its share of the state's key rows, where the cache keeps
them), the sLSTM on each rank's rows and its share of every gate's channels,
gathering h over ``model`` each step.  Without a mesh the code is the
plain one above.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as nn
from repro_torch.sharding.context import (batch_axes, constrain, is_dtensor,
                                          local_dims)

LOG_EPS = -1e30


def _mlstm_dims(cfg: ArchConfig):
    di = 2 * cfg.d_model
    h = cfg.num_heads
    return di, h, di // h


def _chunk_len(cfg: ArchConfig, S: int) -> int:
    """The reference's chunk (``cfg.ssm.chunk``, else 128, at most S), which
    must divide S."""
    chunk = min(cfg.ssm.chunk if cfg.ssm else 128, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    return chunk


def _maybe_checkpoint(fn, remat: bool, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _write_state(state, new):
    """Copy ``new`` into the cache's views ``state`` (if any), on a mesh in
    the cache's placements; returns the state the caller keeps."""
    if state is None:
        return None
    for name, t in new.items():
        dst = state[name]
        if is_dtensor(dst) and t.placements != dst.placements:
            t = t.redistribute(dst.device_mesh, dst.placements)
        dst.copy_(t)
    return state


# ================================================================ mLSTM ==
def mlstm_init(key, cfg: ArchConfig):
    """The reference's key schedule: split(key, 8).  The gates' weights are
    float32 whatever the model's dtype."""
    d = cfg.d_model
    di, h, _ = _mlstm_dims(cfg)
    r = random.split(key, 8)
    dt = cfg.param_dtype
    return {
        "up": nn.dense_init(r[0], d, 2 * di, dtype=dt),      # x branch + gate
        "wq": nn.dense_init(r[1], di, di, dtype=dt),
        "wk": nn.dense_init(r[2], di, di, dtype=dt),
        "wv": nn.dense_init(r[3], di, di, dtype=dt),
        "w_igate": nn.dense_init(r[4], di, h, bias=True, dtype=torch.float32),
        "w_fgate": nn.dense_init(r[5], di, h, bias=True, dtype=torch.float32),
        "out_scale": torch.ones((di,), dtype=dt, device=key.device),
        "down": nn.dense_init(r[6], di, d, dtype=dt),
    }


def mlstm_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                     device):
    _, h, dh = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
            "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
            "m": torch.zeros((batch, h), dtype=dtype, device=device)}


def _headify(t, h):
    B, S, di = t.shape
    return t.reshape(B, S, h, di // h).transpose(1, 2)          # (B,h,S,dh)


def _mlstm_chunk(C0, n0, m0, qc, kc, vc, lic, lfc):
    """One chunk: the carried state (C0, n0, m0) and the chunk's q, k, v
    (B, h, c, dh) and log gates (B, h, c) -> (C1, n1, m1, y)."""
    c = qc.shape[-2]
    Fc = lfc.cumsum(-1)                                          # (B,h,c)
    # intra-chunk log decay D[i, j] = F_i - F_j + li_j, j <= i
    Dm = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=qc.device).tril()
    Dm = torch.where(tri, Dm, LOG_EPS)
    m_inter = m0[..., None] + Fc
    m_i = torch.maximum(m_inter, Dm.amax(-1))                    # (B,h,c)
    E = torch.exp(Dm - m_i[..., None])
    num = ((qc @ kc.transpose(-1, -2)) * E) @ vc
    nvec = E @ kc
    # the state from earlier chunks
    w_in = torch.exp(m_inter - m_i)[..., None]
    num = num + w_in * (qc @ C0)
    nvec = nvec + w_in * n0[:, :, None, :]
    den = torch.maximum((qc * nvec).sum(-1).abs(), torch.exp(-m_i))
    y = num / den[..., None]
    # the chunk-end state
    F_tot = Fc[..., -1]                                          # (B,h)
    lse = F_tot[..., None] - Fc + lic       # each j's log weight at the end
    m_end = torch.maximum(m0 + F_tot, lse.amax(-1))
    wk = torch.exp(lse - m_end[..., None])[..., None] * kc       # (B,h,c,dh)
    decay = torch.exp(m0 + F_tot - m_end)
    # sum_j wj k_j v_j^T as one product: no (B, h, c, dh, dh) intermediate
    C1 = decay[..., None, None] * C0 + wk.transpose(-1, -2) @ vc
    n1 = decay[..., None] * n0 + wk.sum(-2)
    return C1, n1, m_end, y


def _mlstm_heads(q, k, v, li, f, C0=None, n0=None, m0=None, *, mode,
                 chunk, dh, dk=slice(None), reduce=None):
    """The mLSTM recurrence over the heads at hand: q, k, v (B, S, di'),
    the input gate's log li and the forget gate's pre-activation f (B, S,
    h'), with di' = h' dh, and at decode the state (C0, n0, m0) -> (y,) in
    train mode, else (y, C1, n1, m1); y is (B, S, di') float32.  Heads are
    independent, so on a mesh it runs on each rank's heads
    (:func:`mlstm_apply`; ``DTensor`` has no rule for ``log_sigmoid``).  A
    decode step may take the state's key rows ``dk`` only, ``reduce``
    summing the read-out's partial products (:func:`_mlstm_decode_mesh`)."""
    B, S, _ = q.shape
    h = li.shape[-1]
    q = _headify(q, h).float() * dh ** -0.5
    k = _headify(k, h).float()
    v = _headify(v, h).float()
    li, lf = li.transpose(1, 2), F.logsigmoid(f).transpose(1, 2)   # (B,h,S)
    if mode == "decode":
        li0, lf0 = li[..., 0], lf[..., 0]                         # (B,h)
        m1 = torch.maximum(lf0 + m0, li0)
        fg = torch.exp(lf0 + m0 - m1)[..., None, None]
        ig = torch.exp(li0 - m1)[..., None, None]
        # the state's key rows dk: all, or on a mesh this rank's share,
        # whose partial products ``reduce`` sums over the ranks
        q0, k0, v0 = q[:, :, 0, dk], k[:, :, 0, dk], v[:, :, 0]   # (B,h,dh)
        reduce = reduce or (lambda t: t)
        C1 = fg * C0 + ig * (k0[..., :, None] * v0[..., None, :])
        n1 = fg[..., 0] * n0 + ig[..., 0] * k0
        num = reduce((q0[..., None, :] @ C1)[..., 0, :])          # (B,h,dh)
        den = torch.maximum(reduce((q0 * n1).sum(-1)).abs(), torch.exp(-m1))
        y = (num / den[..., None])[:, :, None, :]                 # (B,h,1,dh)
    else:
        remat = mode == "train" and torch.is_grad_enabled()
        C1 = torch.zeros((B, h, dh, dh), dtype=torch.float32, device=q.device)
        n1 = torch.zeros((B, h, dh), dtype=torch.float32, device=q.device)
        m1 = torch.zeros((B, h), dtype=torch.float32, device=q.device)
        ys = []
        for s in range(0, S, chunk):
            C1, n1, m1, yc = _maybe_checkpoint(
                _mlstm_chunk, remat, C1, n1, m1, q[:, :, s:s + chunk],
                k[:, :, s:s + chunk], v[:, :, s:s + chunk],
                li[..., s:s + chunk], lf[..., s:s + chunk])
            ys.append(yc)
        y = torch.cat(ys, dim=2)
    y = y.transpose(1, 2).reshape(B, S, h * dh)
    return (y,) if mode == "train" else (y, C1, n1, m1)


def _mlstm_decode_mesh(run, q, k, v, li, f, C0, n0, m0):
    """A decode step on a mesh, the state left where the cache keeps it:
    each rank updates its rows and its share of C's and n's key rows (the
    cache shards them over ``model``), for every head, and the read-out's
    products over those rows are summed over ``model``, so C never moves
    (a head-sharded step would exchange it into heads and back).  q, k, v
    come in whole (one token a row)."""
    from torch.distributed import _functional_collectives as funcol
    mesh = q.device_mesh
    group = mesh.get_group("model")

    def step(q, k, v, li, f, C0, n0, m0):
        rows = C0.shape[2]
        if rows == C0.shape[3]:                  # model does not divide dk
            return run(q, k, v, li, f, C0, n0, m0)
        r = mesh.get_local_rank("model")
        return run(q, k, v, li, f, C0, n0, m0,
                   dk=slice(r * rows, (r + 1) * rows),
                   reduce=lambda t: funcol.all_reduce(t, "sum", group))
    return local_dims(step, *zip((q, k, v, li, f), ("b..",) * 5),
                      (C0, "b.m."), (n0, "b.m"), (m0, "b."),
                      out=("b..", "b.m.", "b.m", "b."))


def mlstm_apply(p, x, *, cfg: ArchConfig, mode: str, state=None, **_):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    _, _, dh = _mlstm_dims(cfg)
    # on a mesh the product is column-parallel (its gradient reduced into
    # those columns), then gathered over ``model`` once: the halves, q, k,
    # v and the gates take each rank's rows whole, as XLA gathers xb (the
    # activation moves, not the weight)
    up = constrain(nn.dense_apply(nn.tp_weight(p["up"], None, "model"), x),
                   batch_axes(), None, "model")
    xb, zb = constrain(up, batch_axes(), None, None).chunk(2, dim=-1)
    q, k, v = (nn.dense_apply(nn.tp_weight(p[n], None, "model"), xb)
               for n in ("wq", "wk", "wv"))
    li = nn.dense_apply(p["w_igate"], xb.float())                # (B,S,h)
    f = nn.dense_apply(p["w_fgate"], xb.float())

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token a row, got {S}")
        old = (state["C"], state["n"], state["m"])
        chunk = 1
    else:
        old = (None, None, None)
        chunk = _chunk_len(cfg, S)
    run = functools.partial(_mlstm_heads, mode=mode, chunk=chunk, dh=dh)
    if is_dtensor(q) and mode == "decode":
        y, *new = _mlstm_decode_mesh(run, q, k, v, li, f, *old)
    elif is_dtensor(q):
        # on a mesh each rank runs its rows and, where ``model`` divides
        # the heads, its heads (a head's di columns are contiguous); else
        # every head
        roles = ("b.m", "bm..", "bm.", "bm")
        y, *new = local_dims(
            run, *zip((q, k, v, li, f), ("b.m",) * 5), *zip(old, roles[1:]),
            out=roles[:1] if mode == "train" else roles)
    else:
        y, *new = run(q, k, v, li, f, *old)
    if mode != "train":
        state = _write_state(state, dict(zip(("C", "n", "m"), new)))
    else:
        state = None

    # per-channel "group norm" (rms over the channels, the scale per channel)
    y = nn.norm_apply("rmsnorm", {"scale": p["out_scale"]}, y.to(x.dtype))
    return nn.dense_apply(nn.tp_weight(p["down"], "model", None),
                          y * F.silu(zb)), state


# ================================================================ sLSTM ==
def slstm_init(key, cfg: ArchConfig):
    """The reference's key schedule: split(key, 4).  ``rh``, the
    block-diagonal recurrent weights (h, dh, 4 dh), is float32 and drawn by
    ``random.normal``."""
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    r = random.split(key, 4)
    dt = cfg.param_dtype
    pf = max(1, int(d * 4 / 3) // 64 * 64)
    return {
        "wx": nn.dense_init(r[0], d, 4 * d, bias=True, dtype=dt),
        "rh": random.normal(r[1], (h, dh, 4 * dh), torch.float32) * dh ** -0.5,
        "ffn": nn.ffn_init(r[2], "swiglu", d, pf, dtype=dt),
        "ffn_norm": nn.norm_init(cfg.norm, d, dt, device=key.device),
    }


def slstm_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, *,
                     device):
    """c, m and h start at 0 and n at 1."""
    d = cfg.d_model
    zeros = lambda: torch.zeros((batch, d), dtype=dtype, device=device)  # noqa: E731
    return {"c": zeros(), "n": torch.ones((batch, d), dtype=dtype,
                                          device=device),
            "m": zeros(), "h": zeros()}


def _recurrent(rh):
    """The recurrent pre-activations of all 4d gate channels, h (B, d) ->
    (B, 4d): the block-diagonal product "bhd,hde->bhe", as one batched
    product over the heads (an einsum dispatches ~40 ops a step where the
    dry run records them)."""
    nh = rh.shape[0]

    def rec(h):
        B, d = h.shape
        return (h.reshape(B, nh, d // nh).transpose(0, 1) @ rh).transpose(
            0, 1).reshape(B, 4 * d)
    return rec


def _gate_pieces(nh, d, c0, dl):
    """For gate channels c0..c0+dl-1 of each of the 4 gates, the (head,
    first column) of ``rh`` that ``_recurrent``'s flat (head, 4 dh) layout
    puts there, or None where a gate's channels span two heads."""
    e = 4 * d // nh
    out = []
    for g in range(4):
        head, e0 = divmod(g * d + c0, e)
        if e0 + dl > e:
            return None
        out.append((head, e0))
    return out


def _sharded_recurrent(rh, pieces, group):
    """``_recurrent`` for one rank's dl channels of each gate: h's shards
    gathered over ``group`` (the model axis), then each gate's columns of
    its head's block -> (B, 4 dl), the gates in order."""
    from torch.distributed import _functional_collectives as funcol
    # the newer name first (torch 2.13 deprecates the older one)
    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    dh = rh.shape[1]

    def rec(h_local):
        h = gather(h_local, 1, group)
        dl = h_local.shape[1]
        return torch.cat([h[:, i * dh:(i + 1) * dh] @ rh[i, :, e0:e0 + dl]
                          for i, e0 in pieces], dim=-1)
    return rec


def _slstm_step(rec, carry, gx):
    """One step: carry (c, n, m, h), each (B, d'), and the input's gate
    pre-activations gx (B, 4d'), four gates of d' channels -> the new
    carry.  ``rec`` maps h to the recurrent pre-activations in gx's
    layout."""
    c0, n0, m0, h0 = carry
    zi, ii, fi, oi = (gx + rec(h0)).chunk(4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    lf = F.logsigmoid(fi)
    m1 = torch.maximum(lf + m0, ii)
    i_g = torch.exp(ii - m1)
    f_g = torch.exp(lf + m0 - m1)
    c1 = f_g * c0 + i_g * z
    n1 = torch.maximum(f_g * n0 + i_g, torch.exp(-m1))
    return c1, n1, m1, o * c1 / n1


def _slstm_chunk(rec, c, n, m, hh, gxc):
    """The steps of one chunk, gxc (B, c, 4d') -> the carry and ys (B, c,
    d')."""
    carry, ys = (c, n, m, hh), []
    for t in range(gxc.shape[1]):
        carry = _slstm_step(rec, carry, gxc[:, t])
        ys.append(carry[3])
    return (*carry, torch.stack(ys, dim=1))


def _slstm_run(rec, gx_all, c=None, n=None, m=None, hh=None, *, mode,
               chunk):
    """The sLSTM recurrence over the rows and channels at hand: the gate
    pre-activations gx_all (B, S, 4d') and at decode the carry (c, n, m,
    h) -> (y,) in train mode, else (y, c, n, m, h); y is (B, S, d')
    float32."""
    if mode == "decode":
        carry = _slstm_step(rec, (c, n, m, hh), gx_all[:, 0])
        y = carry[3][:, None, :]
    else:
        B, S, d4 = gx_all.shape
        remat = mode == "train" and torch.is_grad_enabled()
        z = torch.zeros((B, d4 // 4), dtype=torch.float32,
                        device=gx_all.device)
        carry = (z, torch.ones_like(z), z, z)
        ys = []
        for s in range(0, S, chunk):
            *carry, yc = _maybe_checkpoint(_slstm_chunk, remat, rec, *carry,
                                           gx_all[:, s:s + chunk])
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    return (y,) if mode == "train" else (y, *carry)


def _slstm_mesh(p, gx_all, old, *, mode, chunk):
    """The sLSTM on a mesh, through ``local_dims``: each rank runs its rows
    and its d/M channels of each gate, h gathered over ``model`` each step,
    as XLA shards the reference's scan.  Each rank's channels of every gate
    must lie in one head's block of ``rh`` (xLSTM-1.3B's 4 heads: always).
    gx and rh come in whole (their gradients are sums over the ranks'
    shares)."""
    rh = p["rh"]
    mesh = gx_all.device_mesh
    nh, d = rh.shape[0], gx_all.shape[-1] // 4
    M = mesh.size(mesh.mesh_dim_names.index("model"))
    dl = d // M
    if d % M or not all(_gate_pieces(nh, d, r * dl, dl) for r in range(M)):
        raise NotImplementedError(f"the sLSTM's {d} channels of {nh} heads "
                                  f"do not shard over model = {M}")
    c0 = mesh.get_local_rank("model") * dl
    pieces = _gate_pieces(nh, d, c0, dl)
    group = mesh.get_group("model")

    def run(rh_, gx, *state):
        B, S, _ = gx.shape
        gx = gx.reshape(B, S, 4, d)[..., c0:c0 + dl].reshape(B, S, 4 * dl)
        return _slstm_run(_sharded_recurrent(rh_, pieces, group), gx,
                          *state, mode=mode, chunk=chunk)
    return local_dims(
        run, (rh, "...+bm"), (gx_all, "b..+m"), *zip(old, ("bm",) * 4),
        out=("b.m",) if mode == "train" else ("b.m",) + ("bm",) * 4)


def slstm_apply(p, x, *, cfg: ArchConfig, mode: str, state=None, **_):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    gx_all = nn.dense_apply(nn.tp_weight(p["wx"], None, "model"),
                            x).float()                           # (B,S,4d)
    names = ("c", "n", "m", "h")
    if mode == "decode":
        old = tuple(state[k] for k in names)
        chunk = 1
    else:
        old = (None,) * 4
        chunk = _chunk_len(cfg, S)
    if is_dtensor(gx_all):
        y, *new = _slstm_mesh(p, gx_all, old, mode=mode, chunk=chunk)
    else:
        y, *new = _slstm_run(_recurrent(p["rh"]), gx_all, *old, mode=mode,
                             chunk=chunk)
    if mode != "train":
        state = _write_state(state, dict(zip(names, new)))
    else:
        state = None

    y = y.to(x.dtype)
    # the post-recurrence gated FFN (the sLSTM block's, proj factor 4/3);
    # on a mesh its input rows whole (the norm's scale is model-sharded)
    # and its row-parallel sum reduced, as a sublayer's
    h = constrain(nn.norm_apply(cfg.norm, p["ffn_norm"], y), batch_axes(),
                  None, None)
    y = y + constrain(nn.ffn_apply("swiglu", p["ffn"], h), batch_axes(),
                      None, None)
    return y, state
