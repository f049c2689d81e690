"""Serve a (reduced) assigned architecture with batched requests in the
PyTorch port: prefill + KV-cache decode, including a sliding-window
long-context path; the sizes of ``examples/serve_llm.py``.

    PYTHONPATH=src python examples/serve_llm_torch.py --arch jamba-v0.1-52b
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu

It runs on the card unless ``--device cpu``.
"""
import argparse
import time

import torch

from repro_torch import random, tree
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.transformer import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen1.5-4b")
ap.add_argument("--batch", type=int, default=2)
ap.add_argument("--prompt-len", type=int, default=32)
ap.add_argument("--gen", type=int, default=16)
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()

dev = resolve_device(args.device)
cfg = get_arch(args.arch).reduced()
max_len = args.prompt_len + args.gen
model = build_model(cfg, max_seq=max_len)
params = model.init(random.PRNGKey(0, dev))
print(f"{cfg.name} reduced: "
      f"{sum(x.numel() for x in tree.leaves(params)):,} params, "
      f"family={cfg.family}")

prefill = make_prefill_step(model, max_len=max_len)
window = cfg.sliding_window if cfg.long_context == "sliding_window" else None
decode = make_serve_step(model, window=window)

batch = {"tokens": random.randint(random.PRNGKey(1, dev),
                                  (args.batch, args.prompt_len), 0,
                                  cfg.vocab_size)}
if cfg.vision_tokens:
    batch["image_embeds"] = torch.zeros(
        (args.batch, cfg.vision_tokens, cfg.d_model), device=dev)
if cfg.encoder_layers:
    batch["encoder_embeds"] = torch.zeros(
        (args.batch, cfg.encoder_seq, cfg.d_model), device=dev)

with torch.no_grad():
    logits, cache = prefill(params, batch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    vision = cfg.vision_tokens or 0
    generated = [tok]
    t0 = time.perf_counter()
    for t in range(args.gen - 1):
        logits, cache = decode(params, tok, cache,
                               vision + args.prompt_len + t)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        generated.append(tok)
    synchronize(dev)
dt = time.perf_counter() - t0
print(f"generated {args.batch}x{args.gen} tokens, "
      f"{dt / max(args.gen - 1, 1) * 1e3:.1f} ms/token"
      + (f" (sliding window={window})" if window else ""))
print("tokens[0]:", torch.cat(generated, 1)[0].tolist())
