"""Step functions of the serving path: the port of
``repro/launch/steps.py``.

``make_prefill_step`` — full-context forward producing logits + KV cache
``make_serve_step``   — ONE new token against a seq_len KV cache (decode)

The train step (``make_train_step``, with the optimizer) waits for the
training slice of the port (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import Model


def softmax_xent(logits, labels):
    """logits: (B, S, V) fp32; labels: (B, S) integers, -1 = ignore."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = model.cache_init(tokens.shape[0], max_len,
                                 device=tokens.device)
        logits, cache, _ = model.apply(params, batch, mode="prefill",
                                       cache=cache)
        return logits[:, -1], cache
    return prefill_step


def make_serve_step(model: Model, window: Optional[int] = None):
    """One decode step: new token + cache @ cache_pos -> logits + cache
    (the cache is updated in place and returned)."""
    def serve_step(params, token, cache, cache_pos):
        batch = {"tokens": token}                      # (B, 1)
        logits, cache, _ = model.apply(params, batch, mode="decode",
                                       cache=cache, cache_pos=cache_pos,
                                       window=window)
        return logits[:, 0], cache
    return serve_step
