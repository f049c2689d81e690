"""The decoder stack: the port of ``repro/models/transformer.py`` for
block patterns of attention (GQA, or MLA where the arch sets it) and Mamba
layers, each with a dense FFN or a mixture of experts (OLMo, Granite,
Qwen1.5, Jamba, DeepSeek-V2, Arctic).

Layers are grouped by the arch's repeating ``block_pattern`` and the
group params are *stacked* along a leading axis (``num_groups``), as in the
reference, so a parameter tree carries across as a copy; the reference's
``lax.scan`` over that axis is a loop here.  xLSTM, encoder-decoder,
vision prefixes, cross-attention and learned positions are not ported yet
and raise in ``build_model`` (ROADMAP queue 1, item 12).
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


class _Mixer(NamedTuple):
    """A mixer kind's init(key, cfg), cache_init(cfg, batch, max_len, *,
    quantized, device) and apply(p, h, *, cfg, mode, positions, cache,
    cache_pos, window) -> (y, new cache)."""
    init: Callable
    cache_init: Callable
    apply: Callable


def _mamba_state_init(cfg, batch, max_len, *, quantized, device):
    # a fixed-size state: no length, and nothing to quantize
    return ssm_lib.mamba_state_init(cfg, batch, device=device)


def _mamba_apply(p, h, *, cfg, mode, positions, cache, cache_pos, window):
    # the recurrence and the conv window carry the order: no positions
    return ssm_lib.mamba_apply(p, h, cfg=cfg, mode=mode, state=cache)


def _mla_cache_init(cfg, batch, max_len, *, quantized, device):
    # the latent cache is already small: int8 applies to GQA caches only
    return attn.mla_cache_init(cfg, batch, max_len, device=device)


# every ported mixer kind; any other raises in build_model
_MIXERS = {
    "attn": _Mixer(attn.gqa_init, attn.gqa_cache_init, attn.gqa_apply),
    "mamba": _Mixer(ssm_lib.mamba_init, _mamba_state_init, _mamba_apply),
}
_MLA = _Mixer(attn.mla_init, _mla_cache_init, attn.mla_apply)


def _mixer(cfg: ArchConfig, sub_idx: int) -> _Mixer:
    kind = cfg.block_pattern[sub_idx]
    return _MLA if kind == "attn" and cfg.mla is not None else _MIXERS[kind]


def _has_moe(cfg: ArchConfig, sub_idx: int) -> bool:
    if cfg.moe is None:
        return False
    kind = cfg.block_pattern[sub_idx]
    if kind not in ("attn", "mamba"):
        return False
    return sub_idx % cfg.moe.every_n_layers == (cfg.moe.every_n_layers - 1) \
        if cfg.moe.every_n_layers > 1 else True


def _unsupported(cfg: ArchConfig) -> Optional[str]:
    """What of ``cfg`` the port lacks, or None."""
    kinds = sorted(set(cfg.block_pattern) - set(_MIXERS))
    if kinds:
        return f"{'/'.join(kinds)} blocks"
    for what, present in (("an encoder", cfg.encoder_layers > 0),
                          ("cross-attention", cfg.cross_attention),
                          ("a vision prefix", cfg.vision_tokens > 0),
                          ("learned positions", cfg.pos_emb == "learned")):
        if present:
            return what
    return None


# ---------------------------------------------------------------- init --
def _init_sublayer(key, cfg: ArchConfig, sub_idx: int) -> Dict[str, Any]:
    r = random.split(key, 5)
    dev = key.device
    p: Dict[str, Any] = {
        "norm1": nn.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                              device=dev),
        "mixer": _mixer(cfg, sub_idx).init(r[0], cfg),
    }
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
    return _mixer(cfg, sub_idx).cache_init(
        cfg, batch, max_len, quantized=quantized, device=device)


def _apply_sublayer(p, x, *, cfg: ArchConfig, sub_idx: int, mode: str,
                    positions, cache_entry, cache_pos, window):
    """Returns (x, new cache, the layer's MoE aux loss or None)."""
    h = nn.norm_apply(cfg.norm, p["norm1"], x)
    y, new_cache = _mixer(cfg, sub_idx).apply(
        p["mixer"], h, cfg=cfg, mode=mode, positions=positions,
        cache=cache_entry, cache_pos=cache_pos, window=window)
    x = x + y
    aux = None
    if "moe" in p:
        h = nn.norm_apply(cfg.norm, p["norm2"], x)
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg)
        x = x + y
    elif "ffn" in p:
        h = nn.norm_apply(cfg.norm, p["norm2"], x)
        x = x + nn.ffn_apply(cfg.ffn, p["ffn"], h)
    return x, new_cache, aux


# ---------------------------------------------------------------- model --
@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    max_seq: int

    # ---------------- params ----------------
    def init(self, key) -> Dict[str, Any]:
        """The reference's key schedule, so the same seed gives the same
        weights: split(key, 8); the groups from split(r[3], num_groups),
        each split per sublayer."""
        cfg = self.cfg
        r = random.split(key, 8)
        params: Dict[str, Any] = {
            "embed": nn.embedding_init(r[0], cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype),
            "final_norm": nn.norm_init(cfg.norm, cfg.d_model,
                                       cfg.param_dtype, device=key.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = nn.dense_init(r[1], cfg.d_model,
                                              cfg.vocab_size,
                                              dtype=cfg.param_dtype)

        def init_group(key_g):
            rs = random.split(key_g, cfg.group_size)
            return {f"sub{i}": _init_sublayer(rs[i], cfg, i)
                    for i in range(cfg.group_size)}

        groups = [init_group(kg) for kg in random.split(r[3], cfg.num_groups)]
        treedef = tree.structure(groups[0])
        groups = [tree.leaves(g) for g in groups]
        # stacked leaf by leaf, each group's copy let go once stacked: the
        # weights are held once, plus one leaf's stack
        stacked = []
        for i in range(len(groups[0])):
            stacked.append(torch.stack([g[i] for g in groups]))
            for g in groups:
                g[i] = None
        params["groups"] = tree.unflatten(treedef, stacked)
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

    # ---------------- main apply ----------------
    def apply(self, params, batch: Dict[str, Any], *, mode: str,
              cache=None, cache_pos=None, window: Optional[int] = None):
        """Returns (logits, new_cache, aux_loss); logits in float32 for
        every position, aux_loss the sum of the MoE layers' (0 without).
        ``cache_pos`` (decode) is an int or a (B,) tensor.  In train mode
        with grad enabled each group runs under activation checkpointing,
        as the reference's.  The cache is written in place (see
        ``attention.gqa_apply`` and ``ssm.mamba_apply``): each group's
        entries are views into it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        x = nn.embedding_apply(params["embed"], tokens)

        if mode == "decode" and isinstance(cache_pos, torch.Tensor):
            positions = cache_pos.expand(B)[:, None]
        elif mode == "decode":          # a fill on the device, no host copy
            positions = torch.full((B, 1), cache_pos, device=dev)
        else:
            positions = torch.arange(S, device=dev)[None]
        x = x.to(cfg.param_dtype)

        def group_body(x, aux, gparams, gcache):
            for i in range(cfg.group_size):
                x, _, a = _apply_sublayer(
                    gparams[f"sub{i}"], x, cfg=cfg, sub_idx=i, mode=mode,
                    positions=positions,
                    cache_entry=None if gcache is None else gcache[f"sub{i}"],
                    cache_pos=cache_pos, window=window)
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
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = group_body(x, aux, gparams, gcache)

        x = nn.norm_apply(cfg.norm, params["final_norm"], x)
        if cfg.tie_embeddings:
            logits = nn.embedding_attend(params["embed"], x)
        else:
            logits = nn.dense_apply(params["lm_head"], x)
        return logits.float(), cache, aux


def build_model(cfg: ArchConfig, max_seq: int = 4096) -> Model:
    missing = _unsupported(cfg)
    if missing is not None:
        raise NotImplementedError(
            f"{cfg.name}: {missing} not ported yet (ROADMAP queue 1, "
            f"item 12); the port serves attention (GQA or MLA) and mamba "
            f"layers with a dense FFN or experts")
    return Model(cfg=cfg, max_seq=max_seq)
