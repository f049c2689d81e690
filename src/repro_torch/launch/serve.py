"""Serving driver: batched prefill + decode loop, on the card unless the
caller asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --device cpu --batch 2 --prompt-len 16 --gen 8

The CLI is the reference's (``repro/launch/serve.py``): it serves the
arch's ``reduced()`` configuration, plus ``--device``.  ``serve()`` takes
any configuration the port supports, at full width.  The weights are drawn
from ``seed`` (the reference's ``PRNGKey(0)``) and the prompts and the
sampling keys from ``seed + 1``, so the same seed gives the reference's
tokens.  An encoder-decoder (Whisper) gets zero ``encoder_embeds`` of
``encoder_seq`` frames and a vision model (LLaVA) zero ``image_embeds`` of
``vision_tokens`` rows, float32, as the reference's CLI makes them.

A vision prefix takes cache positions: the cache and the learned-position
table hold ``vision_tokens + prompt_len + gen`` positions and decode starts
at ``vision_tokens + prompt_len``.  The reference's CLI
(``repro/launch/serve.py``) sizes its cache ``prompt_len + gen``, so its
LLaVA prefill fails to write ``vision_tokens + prompt_len`` positions
there; its model API (``cache_init(B, V + T)``, prefill, decode at ``V +
t``) is what this follows.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import random
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.transformer import build_model


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (batch, gen) int32: the generated tokens
    logits: torch.Tensor          # (batch, vocab) f32: the last step's logits
    init_s: float                 # drawing the weights
    prefill_ms: float             # prefill of the whole batch
    decode_ms_per_step: float     # one decode step (and its sampling)
    tokens_per_s: float           # decode throughput, batch * (gen - 1) tokens


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, window: Optional[int] = None,
          temperature: float = 1.0, device: str = "cuda",
          seed: int = 0) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen - 1`` more: the first token is greedy, the rest sampled
    at ``temperature`` (greedy at 0).  Times end in a device sync."""
    dev = resolve_device(device)
    max_len = cfg.vision_tokens + prompt_len + gen
    model = build_model(cfg, max_seq=max_len)
    t0 = time.perf_counter()
    params = model.init(random.PRNGKey(seed, dev))
    synchronize(dev)
    init_s = time.perf_counter() - t0

    prefill = make_prefill_step(model, max_len=max_len)
    step = make_serve_step(model, window=window)
    rng = random.PRNGKey(seed + 1, dev)
    prompts = random.randint(rng, (batch, prompt_len), 0, cfg.vocab_size)
    inputs = {"tokens": prompts}
    if cfg.vision_tokens:
        inputs["image_embeds"] = torch.zeros(
            (batch, cfg.vision_tokens, cfg.d_model), device=dev)
    if cfg.encoder_layers:
        inputs["encoder_embeds"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), device=dev)

    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        logits, cache = step(params, tok, cache,
                             cfg.vision_tokens + prompt_len + t)
        if temperature > 0:
            rng, k = random.split(rng)
            tok = random.categorical(k, logits / temperature)[:, None]
        else:
            tok = logits.argmax(-1)[:, None]
        tok = tok.to(torch.int32)
        out.append(tok)
    synchronize(dev)
    decode_s = time.perf_counter() - t0
    steps = max(gen - 1, 1)
    return ServeResult(
        tokens=torch.cat(out, dim=1), logits=logits, init_s=init_s,
        prefill_ms=prefill_ms, decode_ms_per_step=decode_s / steps * 1e3,
        tokens_per_s=batch * (gen - 1) / decode_s if gen > 1 else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    res = serve(get_arch(args.arch).reduced(), batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                window=args.window, temperature=args.temperature,
                device=args.device)
    print(f"prefill {args.batch}x{args.prompt_len}: {res.prefill_ms:.1f}ms")
    n_new = args.batch * (args.gen - 1)
    print(f"decode: {n_new} tokens in "
          f"{res.decode_ms_per_step * max(args.gen - 1, 1):.1f}ms "
          f"({res.decode_ms_per_step:.2f}ms/step)")
    print("sample:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
