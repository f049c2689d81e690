#!/usr/bin/env python3
"""How close ``flash_attention``'s gradient comes to autograd's when a
row's attention spreads over many alike keys, and what D = rowsum(P dP)
gains over FlashAttention-2's D = rowsum(dO O) from the forward's bf16
output there.

    python3 tools/flash_bwd_accuracy.py            # keys, on the card
    python3 tools/flash_bwd_accuracy.py cpu        # keys, plain versions only
    python3 tools/flash_bwd_accuracy.py model [L]  # Whisper-medium, L layers

``keys``: bf16 q, k, v and dO at Whisper's cross-attention train shape
(4 x 448 queries on 1500 keys, 16 heads, hd 64; a quarter of the batch
and the keys on the CPU), keys drawn as one vector plus noise of 1, 5 and
1 % of it; dq, dk and dv of the plain backward (``flash_attention_bwd_ref``,
D from P dP), of the same backward with D from the bf16 output, and (on
the card) of both kernel routes, each against torch autograd through the
plain forward in float32 on the same inputs, as a share of the largest
entry of each.  ``model``: Whisper-medium at full width with L decoder
and L encoder layers (24 by default), one gradient on 4 x 448 tokens and
750 encoder frames through the kernels, through the plain versions in
their place (``chip_smoke.with_plain_kernels``) and through the float32
model with the plain versions, leaf by leaf, each bf16 gradient against
the float32 one.  Prints the card's name and power limit first (on the
card), then one line each, then a JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def keys(torch, dev):
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
    from repro_torch.kernels.flash_attention import ref
    B, Sq, Sk, H, hd = (4, 448, 1500, 16, 64) if dev == "cuda" else (
        1, 448, 375, 16, 64)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for spread in (1.0, 0.05, 0.01):
        q = torch.randn(B, Sq, H, hd, device=dev, generator=gen)
        k = (torch.randn(1, 1, H, hd, device=dev, generator=gen)
             + spread * torch.randn(B, Sk, H, hd, device=dev, generator=gen))
        v = torch.randn(B, Sk, H, hd, device=dev, generator=gen)
        do = torch.randn(B, Sq, H, hd, device=dev, generator=gen)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        o32 = ref.flash_attention_ref(*leaves, causal=False)
        want = torch.autograd.grad(o32, leaves, do.float())
        lse = ref.flash_attention_lse_ref(q, k, causal=False)
        got = {"plain, D = rowsum(P dP)": ref.flash_attention_bwd_ref(
            q, k, v, do, lse, causal=False),
            "plain, D = rowsum(dO O), O in bf16": fa2_ref(
                torch, ref, q, k, v, o32.detach().bfloat16(), do, lse)}
        if dev == "cuda":
            got["kernel, tensor cores"] = fb.flash_attention_bwd_cuda(
                q, k, v, do, causal=False)
            got["kernel, CUDA cores"] = [
                g.bfloat16() for g in fb.flash_attention_bwd_cuda(
                    q.float(), k.float(), v.float(), do.float(),
                    causal=False)]
        for name, grads in got.items():
            errs = [rel(g, w) for g, w in zip(grads, want)]
            out[f"spread {spread}, {name}"] = errs
            print(f"  keys {spread:.0%} apart, {name}: dq, dk, dv "
                  f"{', '.join(f'{e:.2e}' for e in errs)} of the largest "
                  f"entry of autograd's")
    return out


def fa2_ref(torch, ref, q, k, v, o, do, lse):
    """``flash_attention_bwd_ref`` with FlashAttention-2's D from the
    output (no mask: every key valid)."""
    hd = q.shape[-1]
    s, _ = ref._scores(q, k, causal=False, window=None)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None])
    scale = hd ** -0.5
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do.float()))


def model(torch, layers):
    from repro_torch import random, tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels.bwo_evolve import bwo_evolve
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models.transformer import build_model
    counters = (bwo_evolve, flash_attention, ssm_scan, flash_attention_bwd,
                ssm_scan_bwd)
    cfg = dataclasses.replace(get_arch("whisper-medium"), num_layers=layers,
                              encoder_layers=layers)
    m = build_model(cfg, max_seq=448)
    m32 = build_model(dataclasses.replace(cfg, param_dtype=torch.float32),
                      max_seq=448)
    params = m.init(random.PRNGKey(0, "cuda"))
    params32 = tree.map(lambda t: t.float(), params)
    key = random.PRNGKey(1, "cuda")
    batch = {"tokens": random.randint(key, (4, 448), 0, cfg.vocab_size),
             "labels": random.randint(random.split(key)[1], (4, 448), 0,
                                      cfg.vocab_size),
             "encoder_embeds": random.normal(random.split(key)[0],
                                             (4, 750, cfg.d_model)) * 0.1}
    _, kernels = make_grad_fn(m)(params, batch)
    _, plain = cs.with_plain_kernels(
        torch, counters, lambda: make_grad_fn(m)(params, batch))
    _, full = cs.with_plain_kernels(
        torch, counters, lambda: make_grad_fn(m32)(params32, batch))
    out = {}
    for path, a, b, c in zip(tree.paths(kernels), tree.leaves(kernels),
                             tree.leaves(plain), tree.leaves(full)):
        out[path] = [rel(a, c), rel(b, c)]
        print(f"  {path}: through the kernels {out[path][0]:.2e}, through "
              f"the plain versions {out[path][1]:.2e} of the float32 "
              f"gradient's largest entry ({c.abs().max().item():.3e})")
    return out


def main() -> int:
    import torch
    what = sys.argv[1] if len(sys.argv) > 1 else "keys"
    if what not in ("keys", "cpu", "model"):
        print(__doc__, file=sys.stderr)
        return 2
    if what != "cpu":
        if not torch.cuda.is_available():
            print("flash_bwd_accuracy: torch sees no CUDA device",
                  file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    if what == "model":
        out = model(torch, int(sys.argv[2]) if len(sys.argv) > 2 else 24)
    else:
        out = keys(torch, "cuda" if what == "keys" else "cpu")
    print(json.dumps({what: out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
