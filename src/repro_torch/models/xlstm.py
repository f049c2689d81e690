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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as nn

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
    """Copy ``new`` into the cache's views ``state`` (if any); returns the
    state the caller keeps."""
    if state is None:
        return None
    for name, t in new.items():
        state[name].copy_(t)
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


def mlstm_apply(p, x, *, cfg: ArchConfig, mode: str, state=None, **_):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    di, h, dh = _mlstm_dims(cfg)
    up = nn.dense_apply(p["up"], x)
    xb, zb = up.chunk(2, dim=-1)                                 # (B,S,di)
    q = _headify(nn.dense_apply(p["wq"], xb), h).float() * dh ** -0.5
    k = _headify(nn.dense_apply(p["wk"], xb), h).float()
    v = _headify(nn.dense_apply(p["wv"], xb), h).float()
    li = nn.dense_apply(p["w_igate"], xb.float()).transpose(1, 2)  # (B,h,S)
    lf = F.logsigmoid(nn.dense_apply(p["w_fgate"], xb.float())).transpose(1, 2)

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token a row, got {S}")
        C0, n0, m0 = state["C"], state["n"], state["m"]
        li0, lf0 = li[..., 0], lf[..., 0]                         # (B,h)
        m1 = torch.maximum(lf0 + m0, li0)
        fg = torch.exp(lf0 + m0 - m1)[..., None, None]
        ig = torch.exp(li0 - m1)[..., None, None]
        q0, k0, v0 = q[:, :, 0], k[:, :, 0], v[:, :, 0]           # (B,h,dh)
        C1 = fg * C0 + ig * (k0[..., :, None] * v0[..., None, :])
        n1 = fg[..., 0] * n0 + ig[..., 0] * k0
        num = (q0[..., None, :] @ C1)[..., 0, :]                  # (B,h,dh)
        den = torch.maximum((q0 * n1).sum(-1).abs(), torch.exp(-m1))
        y = (num / den[..., None])[:, :, None, :]                 # (B,h,1,dh)
        state = _write_state(state, {"C": C1, "n": n1, "m": m1})
    else:
        chunk = _chunk_len(cfg, S)
        remat = mode == "train" and torch.is_grad_enabled()
        C1 = torch.zeros((B, h, dh, dh), dtype=torch.float32, device=x.device)
        n1 = torch.zeros((B, h, dh), dtype=torch.float32, device=x.device)
        m1 = torch.zeros((B, h), dtype=torch.float32, device=x.device)
        ys = []
        for s in range(0, S, chunk):
            C1, n1, m1, yc = _maybe_checkpoint(
                _mlstm_chunk, remat, C1, n1, m1, q[:, :, s:s + chunk],
                k[:, :, s:s + chunk], v[:, :, s:s + chunk],
                li[..., s:s + chunk], lf[..., s:s + chunk])
            ys.append(yc)
        y = torch.cat(ys, dim=2)
        if mode == "prefill":
            state = _write_state(state, {"C": C1, "n": n1, "m": m1})
        else:
            state = None

    y = y.transpose(1, 2).reshape(B, y.shape[2], di)
    # per-channel "group norm" (rms over the channels, the scale per channel)
    y = nn.norm_apply("rmsnorm", {"scale": p["out_scale"]}, y.to(x.dtype))
    return nn.dense_apply(p["down"], y * F.silu(zb)), state


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


def _slstm_step(rh, carry, gx):
    """One step: carry (c, n, m, h), each (B, d), and the input's gate
    pre-activations gx (B, 4d) -> the new carry."""
    c0, n0, m0, h0 = carry
    B, d = h0.shape
    nh = rh.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h0.reshape(B, nh, d // nh),
                       rh).reshape(B, 4 * d)
    zi, ii, fi, oi = (gx + rec).chunk(4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    lf = F.logsigmoid(fi)
    m1 = torch.maximum(lf + m0, ii)
    i_g = torch.exp(ii - m1)
    f_g = torch.exp(lf + m0 - m1)
    c1 = f_g * c0 + i_g * z
    n1 = torch.maximum(f_g * n0 + i_g, torch.exp(-m1))
    return c1, n1, m1, o * c1 / n1


def _slstm_chunk(rh, c, n, m, hh, gxc):
    """The steps of one chunk, gxc (B, c, 4d) -> the carry and ys (B, c, d)."""
    carry, ys = (c, n, m, hh), []
    for t in range(gxc.shape[1]):
        carry = _slstm_step(rh, carry, gxc[:, t])
        ys.append(carry[3])
    return (*carry, torch.stack(ys, dim=1))


def slstm_apply(p, x, *, cfg: ArchConfig, mode: str, state=None, **_):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    gx_all = nn.dense_apply(p["wx"], x).float()                  # (B,S,4d)
    names = ("c", "n", "m", "h")
    if mode == "decode":
        carry = _slstm_step(p["rh"], tuple(state[k] for k in names),
                            gx_all[:, 0])
        y = carry[3][:, None, :]
        state = _write_state(state, dict(zip(names, carry)))
    else:
        chunk = _chunk_len(cfg, S)
        remat = mode == "train" and torch.is_grad_enabled()
        z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (z, torch.ones_like(z), z, z)
        ys = []
        for s in range(0, S, chunk):
            *carry, yc = _maybe_checkpoint(_slstm_chunk, remat, p["rh"],
                                           *carry, gx_all[:, s:s + chunk])
            ys.append(yc)
        y = torch.cat(ys, dim=1)
        if mode == "prefill":
            state = _write_state(state, dict(zip(names, carry)))
        else:
            state = None

    y = y.to(x.dtype)
    # the post-recurrence gated FFN (the sLSTM block's, proj factor 4/3)
    y = y + nn.ffn_apply("swiglu", p["ffn"],
                         nn.norm_apply(cfg.norm, p["ffn_norm"], y))
    return y, state
