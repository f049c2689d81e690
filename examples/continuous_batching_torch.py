"""Continuous-batching serving demo in the PyTorch port: 6 mixed-length
requests through a 3-slot engine (vLLM-style slot reuse, per-slot cache
positions), as ``examples/continuous_batching.py``.

    PYTHONPATH=src python examples/continuous_batching_torch.py --arch granite-8b
    PYTHONPATH=src python examples/continuous_batching_torch.py --device cpu

It runs on the card unless ``--device cpu``.
"""
import argparse
import time

from repro_torch import random
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.serving import BatchedServer, Request

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="granite-8b")
ap.add_argument("--slots", type=int, default=3)
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()

dev = resolve_device(args.device)
cfg = get_arch(args.arch).reduced()
model = build_model(cfg, max_seq=96)
params = model.init(random.PRNGKey(0, dev))
server = BatchedServer(model, params, max_batch=args.slots, max_len=96,
                       device=args.device)

for i, plen in enumerate([5, 11, 8, 17, 6, 9]):
    server.submit(Request(
        uid=i, prompt=random.randint(random.PRNGKey(i, dev), (plen,),
                                     0, cfg.vocab_size),
        max_new_tokens=8))

t0 = time.perf_counter()
stats = server.run()
dt = time.perf_counter() - t0
print(f"{cfg.name} reduced | {args.slots} slots | stats={stats} "
      f"| {dt:.1f}s total")
