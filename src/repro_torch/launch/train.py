"""The training entry point: the port of ``repro/launch/train.py``, with
the reference's flags plus ``--device`` (the card unless the CPU is asked
for; without a card, ``cuda`` raises).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir /tmp/ckpt \\
        --ckpt-every 3

As the reference's, it trains the arch's ``reduced()`` configuration
(``--reduced`` is on by default and stays on) on synthetic Markov tokens,
with AdamW under ``warmup_cosine(lr, 10, steps)``.  A vision model gets
zero ``image_embeds`` and an encoder-decoder zero ``encoder_embeds``
(float32), as the reference's CLI gives them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim as opt_lib
from repro_torch import random, tree
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, max_seq=args.seq)
    optimizer = opt_lib.adamw(opt_lib.warmup_cosine(args.lr, 10, args.steps))
    train_step, init_state = make_train_step(model, optimizer)

    state = init_state(random.PRNGKey(0, dev))
    n_params = sum(x.numel() for x in tree.leaves(state["params"]))
    print(f"arch={cfg.name} (reduced={args.reduced}) params={n_params:,} "
          f"device={dev}")

    data = make_token_dataset(random.PRNGKey(1, dev),
                              n_seqs=args.batch * 8, seq_len=args.seq,
                              vocab=cfg.vocab_size)
    extra = {}
    if cfg.vision_tokens:
        extra["image_embeds"] = torch.zeros(
            (args.batch, cfg.vision_tokens, cfg.d_model), device=dev)
    if cfg.encoder_layers:
        extra["encoder_embeds"] = torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), device=dev)

    nb = data["tokens"].shape[0] // args.batch
    t0 = time.perf_counter()
    for step in range(args.steps):
        i = step % nb
        batch = {k: v[i * args.batch:(i + 1) * args.batch]
                 for k, v in data.items()}
        batch.update(extra)
        state, metrics = train_step(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            synchronize(dev)
            dt = time.perf_counter() - t0
            print(f"step {step:5d}  loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt / (step + 1):.3f}s/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1, state)
            print(f"checkpoint -> {path}")
    print("done")


if __name__ == "__main__":
    main()
