"""Step functions: the port of ``repro/launch/steps.py``.

``make_train_step``   — fwd + bwd + AdamW update (train_4k), in place
``make_prefill_step`` — full-context forward producing logits + KV cache
``make_serve_step``   — ONE new token against a seq_len KV cache (decode)
``make_serve_step_encdec`` — the same, with the encoder's output passed in
``input_specs``       — stand-ins for every model input (meta tensors)

The train step's gradients come from autograd: on the card through the
flash-attention and scan kernels' backward kernels, on the CPU through the
plain versions.  ``make_grad_fn`` is its first part alone (loss, aux and
gradients), for callers that look at the gradients.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import optim as opt_lib
from repro_torch import tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.transformer import Model


def softmax_xent(logits, labels):
    """logits: (B, S, V) fp32; labels: (B, S) integers, -1 = ignore."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, _, aux = model.apply(params, batch, mode="train")
        loss = softmax_xent(logits, batch["labels"])
        return loss + aux, (loss, aux)
    return loss_fn


def make_grad_fn(model: Model, accum_steps: int = 1):
    """``grad_fn(params, batch) -> ((total, loss, aux), grads)``: detached
    0-dim float32 metrics and the gradient of ``total`` as a tree shaped as
    ``params``.  ``accum_steps > 1`` splits the batch into microbatches
    taken in turn, their gradients summed in float32 (each divided by
    accum_steps first, as the reference's scan adds them), so the result
    is the full batch's at 1/accum_steps the activation memory; with 1, the
    gradients are in the parameters' types."""
    loss_fn = make_loss_fn(model)

    def one(params, leaves, batch):
        total, (loss, aux) = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as jax.grad's
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (total.detach(), loss.detach(), aux.detach()), grads

    def grad_fn(params, batch):
        leaves = tree.leaves(params)
        treedef = tree.structure(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if accum_steps == 1:
                metrics, grads = one(params, leaves, batch)
                return metrics, tree.unflatten(treedef, grads)
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            sums = [torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                    for _ in range(3)]
            for i in range(accum_steps):
                metrics, grads = one(params, leaves,
                                     {k: v[i] for k, v in micro.items()})
                for a, g in zip(acc, grads):
                    a.add_(g.float() / accum_steps)
                for s, m in zip(sums, metrics):
                    s.add_(m / accum_steps)
                del grads
            return tuple(sums), tree.unflatten(treedef, acc)
        finally:
            for p in leaves:
                p.requires_grad_(False)

    return grad_fn


def make_train_step(model: Model, optimizer: Optional[opt_lib.Optimizer] = None,
                    accum_steps: int = 1):
    """(train_step, init_state).  ``train_step(state, batch) -> (state,
    metrics)``: the gradient (``make_grad_fn``), clipped to a global norm
    of 1, then the optimizer's update (AdamW under ``warmup_cosine(3e-4,
    100, 10_000)`` by default).  The parameters and the optimizer's
    moments are updated in place, as the reference donates its state: the
    returned state holds the same tensors and a new step count.  Metrics
    ``loss``, ``aux`` and ``grad_norm`` are 0-dim tensors on the device
    (nothing is read back to the host)."""
    optimizer = optimizer or opt_lib.adamw(
        opt_lib.warmup_cosine(3e-4, 100, 10_000))
    grad_fn = make_grad_fn(model, accum_steps)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        (_, loss, aux), grads = grad_fn(state["params"], batch)
        gnorm = opt_lib.clip_by_global_norm_(grads, 1.0)
        optimizer.update_(state["params"], grads, state["opt"], state["step"])
        new_state = {"params": state["params"], "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "aux": aux, "grad_norm": gnorm}

    def init_state(key):
        params = model.init(key)
        return {"params": params, "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=key.device)}

    return train_step, init_state


def make_prefill_step(model: Model, max_len: int, cache_init=None):
    """Prefill: a new cache of ``max_len`` positions, then the whole batch
    (tokens, and ``image_embeds`` / ``encoder_embeds`` as they are) ->
    the last position's logits and the filled cache.  With a vision prefix
    ``max_len`` counts its positions too.  ``cache_init(batch, max_len,
    device)`` makes the new cache (``model.cache_init`` by default; the dry
    run passes one that builds it sharded)."""
    cache_init = cache_init or (lambda b, n, device: model.cache_init(
        b, n, device=device))

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = cache_init(tokens.shape[0], max_len, tokens.device)
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


def make_serve_step_encdec(model: Model, window: Optional[int] = None):
    """One decode step of an encoder-decoder with the encoder's output
    ``enc_out`` in the batch (cross-attention still reads the K/V that
    prefill cached)."""
    def serve_step(params, token, cache, cache_pos, enc_out):
        batch = {"tokens": token, "enc_out": enc_out}
        logits, cache, _ = model.apply(params, batch, mode="decode",
                                       cache=cache, cache_pos=cache_pos,
                                       window=window)
        return logits[:, 0], cache
    return serve_step


# ------------------------------------------------------------- specs ----
def input_specs(cfg: ArchConfig, shape: InputShape, *,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input, on the meta device (shapes and
    dtypes, no storage): the reference's ``ShapeDtypeStruct``s, by name."""
    B, S = shape.global_batch, shape.seq_len

    def sd(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    specs: Dict[str, Any] = {}
    if shape.mode in ("train", "prefill"):
        specs["tokens"] = sd((B, S), torch.int32)
        if shape.mode == "train":
            specs["labels"] = sd((B, S), torch.int32)
        if cfg.vision_tokens:
            specs["image_embeds"] = sd((B, cfg.vision_tokens, cfg.d_model),
                                       dtype)
        if cfg.encoder_layers:
            specs["encoder_embeds"] = sd((B, cfg.encoder_seq, cfg.d_model),
                                         dtype)
    else:  # decode
        # enc-dec archs need no encoder inputs at decode time: cross K/V
        # are prefilled into the cache (see attention.gqa_apply)
        specs["tokens"] = sd((B, 1), torch.int32)
    return specs
