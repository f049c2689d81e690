"""Quickstart in the PyTorch port: FedBWO on the paper's CNN.

Runs three federated rounds of the paper's protocol (every client trains
locally + refines with BWO, uploads a 4-byte score, the server adopts
the best client's weights) and prints the communication ledger.  All the
wiring -- dataset synthesis, partitioning, client batching, server and
stop conditions -- hangs off one ``FLConfig`` (repro_torch.core.api), the
same configuration as ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It runs on the card unless ``--device cpu``.
"""
import argparse

from repro_torch.core import FLConfig, build_experiment

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()

# ``engine="auto"``: on the CPU, conv tasks like this CNN stay on the
# sequential per-client loop (DESIGN.md §4); on the card the round's
# clients run as one batched update (vmap over clients).
cfg = FLConfig(strategy="fedbwo", task="cnn", n_clients=5,
               n_train=600, n_test=200, batch_size=10,
               local_epochs=1, mh_pop=4, mh_generations=2,
               engine="auto", vectorize="auto",
               max_rounds=3, tau=0.95,
               data_seed=0, partition_seed=1, server_seed=7,
               device=args.device)
exp = build_experiment(cfg)
print(f"round engine = {exp.server.engine}")
print(f"FedBWO | {cfg.n_clients} clients | model = "
      f"{exp.meter.model_bytes / 1e6:.1f} MB")

result = exp.run(verbose=True)

s = result.summary()
print(f"\nrounds={s['rounds']}  uplink={s['comm']['uplink_bytes']:,} bytes "
      f"(score uplink per round = {cfg.n_clients * 4} bytes "
      f"+ one model fetch)")
print(f"final accuracy = {s['final_acc']:.3f}")
