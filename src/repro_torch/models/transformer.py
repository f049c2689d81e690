"""The decoder and encoder-decoder stack: the port of
``repro/models/transformer.py`` for every block pattern of the reference:
attention (GQA, or MLA where the arch sets it) and Mamba layers, each with
a dense FFN or a mixture of experts (OLMo, Granite, Qwen1.5, Jamba,
DeepSeek-V2, Arctic), xLSTM's mLSTM and sLSTM blocks, Whisper's encoder,
cross-attention and learned positions, and LLaVA's vision prefix.

Layers are grouped by the arch's repeating ``block_pattern`` and the
group params are *stacked* along a leading axis (``num_groups``; the
encoder's layers along ``encoder_layers``), as in the reference, so a
parameter tree carries across as a copy; the reference's ``lax.scan`` over
that axis is a loop here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.sharding import batch_axes, constrain


class _Mixer(NamedTuple):
    """A mixer kind's init(key, cfg), cache_init(cfg, batch, max_len, *,
    quantized, device) and apply(p, h, *, cfg, mode, positions, cache,
    cache_pos, window) -> (y, new cache)."""
    init: Callable
    cache_init: Callable
    apply: Callable


def _mla_cache_init(cfg, batch, max_len, *, quantized, device):
    # the latent cache is already small: int8 applies to GQA caches only
    return attn.mla_cache_init(cfg, batch, max_len, device=device)


def _recurrent(init, state_init, apply) -> _Mixer:
    """A mixer whose cache is a fixed-size state (Mamba's, xLSTM's): no
    length, nothing to quantize; the recurrence carries the order, so no
    positions."""
    def cache_init(cfg, batch, max_len, *, quantized, device):
        return state_init(cfg, batch, device=device)

    def apply_(p, h, *, cfg, mode, positions, cache, cache_pos, window):
        return apply(p, h, cfg=cfg, mode=mode, state=cache)

    return _Mixer(init, cache_init, apply_)


_MIXERS = {
    "attn": _Mixer(attn.gqa_init, attn.gqa_cache_init, attn.gqa_apply),
    "mamba": _recurrent(ssm_lib.mamba_init, ssm_lib.mamba_state_init,
                        ssm_lib.mamba_apply),
    "mlstm": _recurrent(xlstm_lib.mlstm_init, xlstm_lib.mlstm_state_init,
                        xlstm_lib.mlstm_apply),
    "slstm": _recurrent(xlstm_lib.slstm_init, xlstm_lib.slstm_state_init,
                        xlstm_lib.slstm_apply),
}
_MLA = _Mixer(attn.mla_init, _mla_cache_init, attn.mla_apply)


def _mixer(cfg: ArchConfig, sub_idx: int) -> _Mixer:
    kind = cfg.block_pattern[sub_idx]
    if kind not in _MIXERS:
        raise ValueError(kind)
    return _MLA if kind == "attn" and cfg.mla is not None else _MIXERS[kind]


def _has_moe(cfg: ArchConfig, sub_idx: int) -> bool:
    if cfg.moe is None:
        return False
    kind = cfg.block_pattern[sub_idx]
    if kind not in ("attn", "mamba"):
        return False
    return sub_idx % cfg.moe.every_n_layers == (cfg.moe.every_n_layers - 1) \
        if cfg.moe.every_n_layers > 1 else True


def _has_cross(cfg: ArchConfig, sub_idx: int) -> bool:
    return cfg.cross_attention and cfg.block_pattern[sub_idx] == "attn"


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's layers: attention and a dense FFN, as the
    reference's."""
    return dataclasses.replace(cfg, block_pattern=("attn",),
                               cross_attention=False, moe=None, mla=None)


def _stacked(init_fn, keys) -> Dict[str, Any]:
    """``init_fn(key)`` for each key, stacked leaf by leaf along a new
    leading axis (the reference's vmap over the keys), each copy let go
    once stacked: the weights are held once, plus one leaf's stack."""
    trees = [init_fn(k) for k in keys]
    treedef = tree.structure(trees[0])
    trees = [tree.leaves(t) for t in trees]
    stacked = []
    for i in range(len(trees[0])):
        stacked.append(torch.stack([t[i] for t in trees]))
        for t in trees:
            t[i] = None
    return tree.unflatten(treedef, stacked)


# ---------------------------------------------------------------- init --
def _init_sublayer(key, cfg: ArchConfig, sub_idx: int) -> Dict[str, Any]:
    r = random.split(key, 5)
    dev = key.device
    p: Dict[str, Any] = {
        "norm1": nn.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                              device=dev),
        "mixer": _mixer(cfg, sub_idx).init(r[0], cfg),
    }
    if _has_cross(cfg, sub_idx):
        p["norm_x"] = nn.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                                   device=dev)
        p["cross"] = attn.gqa_init(r[1], cfg, cross=True)
    if cfg.block_pattern[sub_idx] not in ("attn", "mamba"):
        return p                # an xLSTM block carries its own projections
    if _has_moe(cfg, sub_idx) or cfg.ffn != "none":
        p["norm2"] = nn.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                                  device=dev)
    if _has_moe(cfg, sub_idx):
        p["moe"] = moe_lib.moe_init(r[2], cfg)
    elif cfg.ffn != "none":
        p["ffn"] = nn.ffn_init(r[2], cfg.ffn, cfg.d_model, cfg.d_ff,
                               cfg.param_dtype)
    return p


def _cache_sublayer(cfg: ArchConfig, sub_idx: int, batch: int,
                    max_len: int, quantized: bool, device):
    own = _mixer(cfg, sub_idx).cache_init(
        cfg, batch, max_len, quantized=quantized, device=device)
    if not _has_cross(cfg, sub_idx):
        return own
    # the cross K/V, computed once at prefill and read at every decode step
    shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"self": own,
            "cross": {n: torch.zeros(shape, dtype=torch.bfloat16,
                                     device=device) for n in ("ck", "cv")}}


def _apply_sublayer(p, x, *, cfg: ArchConfig, sub_idx: int, mode: str,
                    positions, cache_entry, cache_pos, window, enc_out):
    """Returns (x, the layer's cache entry, the layer's MoE aux loss or
    None).  A layer with cross-attention keeps its cache as {"self",
    "cross"}.

    On a mesh each block's output is constrained to the batch layout before
    it joins the residual, as the reference constrains the FFN's: a
    ``DTensor`` keeps a row-parallel product's sum pending (``Partial``)
    until an op needs it, where XLA reduces it at once, and the norm and
    the next block would run on the pending sum (each rank gathering the
    next weights whole).  Without a mesh these are identities."""
    nested = "cross" in p and cache_entry is not None
    h = nn.norm_apply(cfg.norm, p["norm1"], x)
    y, _ = _mixer(cfg, sub_idx).apply(
        p["mixer"], h, cfg=cfg, mode=mode, positions=positions,
        cache=cache_entry["self"] if nested else cache_entry,
        cache_pos=cache_pos, window=window)
    x = x + constrain(y, batch_axes(), None, None)
    if "cross" in p:
        h = nn.norm_apply(cfg.norm, p["norm_x"], x)
        y, _ = attn.gqa_apply(p["cross"], h, cfg=cfg, mode=mode,
                              positions=positions, kv_source=enc_out,
                              cache=cache_entry["cross"] if nested else None,
                              cross=True)
        x = x + constrain(y, batch_axes(), None, None)
    aux = None
    if "moe" in p:
        h = nn.norm_apply(cfg.norm, p["norm2"], x)
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg)
        x = x + constrain(y, batch_axes(), None, None)
    elif "ffn" in p:
        h = nn.norm_apply(cfg.norm, p["norm2"], x)
        y = constrain(nn.ffn_apply(cfg.ffn, p["ffn"], h),
                      batch_axes(), None, None)
        x = x + y
    return x, cache_entry, aux


# ---------------------------------------------------------------- model --
@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    max_seq: int

    # ---------------- params ----------------
    def init(self, key) -> Dict[str, Any]:
        """The reference's key schedule, so the same seed gives the same
        weights: split(key, 8); learned positions from r[2] (``max_seq``
        rows); the groups from split(r[3], num_groups), each split per
        sublayer; the encoder's layers from split(r[4], encoder_layers)
        and its positions from r[5] (``max(encoder_seq, 8)`` rows)."""
        cfg = self.cfg
        dev = key.device
        r = random.split(key, 8)
        params: Dict[str, Any] = {
            "embed": nn.embedding_init(r[0], cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype),
            "final_norm": nn.norm_init(cfg.norm, cfg.d_model,
                                       cfg.param_dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = nn.dense_init(r[1], cfg.d_model,
                                              cfg.vocab_size,
                                              dtype=cfg.param_dtype)
        if cfg.pos_emb == "learned":
            params["pos_embed"] = nn.embedding_init(
                r[2], self.max_seq, cfg.d_model, cfg.param_dtype)

        def init_group(key_g):
            rs = random.split(key_g, cfg.group_size)
            return {f"sub{i}": _init_sublayer(rs[i], cfg, i)
                    for i in range(cfg.group_size)}

        params["groups"] = _stacked(init_group,
                                    random.split(r[3], cfg.num_groups))
        if cfg.encoder_layers:
            enc_cfg = _encoder_cfg(cfg)
            params["encoder"] = _stacked(
                lambda k: _init_sublayer(k, enc_cfg, 0),
                random.split(r[4], cfg.encoder_layers))
            params["enc_pos"] = nn.embedding_init(
                r[5], max(cfg.encoder_seq, 8), cfg.d_model, cfg.param_dtype)
            params["enc_norm"] = nn.norm_init(cfg.norm, cfg.d_model,
                                              cfg.param_dtype, device=dev)
        return params

    # ---------------- cache ----------------
    def cache_init(self, batch: int, max_len: int, quantized: bool = False,
                   *, device) -> Dict[str, Any]:
        cfg = self.cfg
        one_group = {f"sub{i}": _cache_sublayer(cfg, i, batch, max_len,
                                                quantized, device)
                     for i in range(cfg.group_size)}
        return tree.map(lambda a: a.new_zeros((cfg.num_groups, *a.shape)),
                        one_group)

    # ---------------- encoder ----------------
    def _encode(self, params, enc_embeds):
        """enc_embeds: (B, enc_S, d), the stubbed frontend's frames ->
        the encoder's output (B, enc_S, d).  The frames plus learned
        positions keep the wider type, and so does every layer: float32
        frames run a bf16 encoder in float32 (``nn.dense_apply`` takes the
        weights as float32; attention on the kernels' float32 route), as
        JAX's promotion runs the reference's.  Bidirectional attention,
        each layer's FFN, then ``enc_norm``; no activation checkpointing,
        as the reference's."""
        cfg = self.cfg
        enc_cfg = _encoder_cfg(cfg)
        S = enc_embeds.shape[1]
        pos = torch.arange(S, device=enc_embeds.device)
        x = enc_embeds + nn.embedding_apply(params["enc_pos"], pos)[None]
        for i in range(cfg.encoder_layers):
            lp = tree.map(lambda a: a[i], params["encoder"])
            h = nn.norm_apply(cfg.norm, lp["norm1"], x)
            y, _ = attn.gqa_apply(lp["mixer"], h, cfg=enc_cfg, mode="encode",
                                  positions=pos[None])
            x = x + y
            h = nn.norm_apply(cfg.norm, lp["norm2"], x)
            x = x + nn.ffn_apply(cfg.ffn, lp["ffn"], h)
        return nn.norm_apply(cfg.norm, params["enc_norm"], x)

    # ---------------- main apply ----------------
    def apply(self, params, batch: Dict[str, Any], *, mode: str,
              cache=None, cache_pos=None, window: Optional[int] = None):
        """Returns (logits, new_cache, aux_loss); logits in float32 for
        every text position, aux_loss the sum of the MoE layers' (0
        without).  ``batch``: tokens (B, S); ``image_embeds`` (B, V, d),
        put ahead of the tokens outside decode (the vision prefix, whose
        logits are dropped); ``encoder_embeds`` (B, enc_S, d) for an
        encoder-decoder outside decode, ``enc_out`` optional at decode
        (cross-attention reads the K/V prefill cached).  ``cache_pos``
        (decode) is an int or a (B,) tensor.  In train mode with grad
        enabled each group runs under activation checkpointing, as the
        reference's.  The cache is written in place (see
        ``attention.gqa_apply`` and ``ssm.mamba_apply``): each group's
        entries are views into it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        x = nn.embedding_apply(params["embed"], tokens)

        n_prefix = 0
        if cfg.vision_tokens and mode != "decode":
            img = batch["image_embeds"].to(x.dtype)
            n_prefix = img.shape[1]
            x = torch.cat([img, x], dim=1)

        if mode == "decode" and isinstance(cache_pos, torch.Tensor):
            positions = cache_pos.expand(B)[:, None]
        elif mode == "decode":          # a fill on the device, no host copy
            positions = torch.full((B, 1), cache_pos, device=dev)
        else:
            positions = torch.arange(x.shape[1], device=dev)[None]
        if cfg.pos_emb == "learned":
            x = x + nn.embedding_apply(params["pos_embed"], positions.long())
        x = constrain(x.to(cfg.param_dtype), batch_axes(), None, None)

        enc_out = None
        if cfg.encoder_layers:
            enc_out = (batch.get("enc_out") if mode == "decode"
                       else self._encode(params, batch["encoder_embeds"]))

        def group_body(x, aux, gparams, gcache, enc_out):
            for i in range(cfg.group_size):
                x, _, a = _apply_sublayer(
                    gparams[f"sub{i}"], x, cfg=cfg, sub_idx=i, mode=mode,
                    positions=positions,
                    cache_entry=None if gcache is None else gcache[f"sub{i}"],
                    cache_pos=cache_pos, window=window, enc_out=enc_out)
                x = constrain(x, batch_axes(), None, None)
                if a is not None:
                    aux = aux + a
            return x, aux

        # the MoE layers' load-balance losses, summed in the reference's
        # order (groups, then sublayers)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        remat = mode == "train" and torch.is_grad_enabled()
        for g in range(cfg.num_groups):
            gparams = tree.map(lambda a: a[g], params["groups"])
            gcache = None if cache is None else tree.map(lambda a: a[g], cache)
            if remat:
                # the reference's jax.checkpoint(group_body): a group's
                # activations are recomputed in the backward, not kept
                x, aux = checkpoint(group_body, x, aux, gparams, gcache,
                                    enc_out, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = group_body(x, aux, gparams, gcache, enc_out)

        x = nn.norm_apply(cfg.norm, params["final_norm"], x)
        if cfg.tie_embeddings:
            logits = nn.embedding_attend(params["embed"], x)
        else:
            logits = nn.dense_apply(
                nn.tp_weight(params["lm_head"], None, "model"), x)
        logits = constrain(logits[:, n_prefix:], batch_axes(), None, "model")
        return logits.float(), cache, aux


def build_model(cfg: ArchConfig, max_seq: int = 4096) -> Model:
    return Model(cfg=cfg, max_seq=max_seq)
