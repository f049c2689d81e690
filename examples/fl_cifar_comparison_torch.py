"""End to end in the PyTorch port: the paper's experiment -- FedBWO
vs FedAvg / FedPSO / FedGWO / FedSCA on (synthetic) CIFAR-10 with the
paper's hyper-parameters (10 clients, batch 10, lr 0.0025, tau=0.70), and
the Eq. 1-4 communication-cost comparison.  Each run is one ``FLConfig``
through the experiment facade (repro_torch.core.api), configured as in
``examples/fl_cifar_comparison.py``.

    PYTHONPATH=src python examples/fl_cifar_comparison_torch.py [--fast]
    PYTHONPATH=src python examples/fl_cifar_comparison_torch.py --fast --device cpu

It runs on the card unless ``--device cpu``.
"""
import argparse

from repro_torch.core import FLConfig, build_experiment
from repro_torch.core.api import strategy_names

ap = argparse.ArgumentParser()
ap.add_argument("--fast", action="store_true",
                help="tiny sizes for a quick demo")
ap.add_argument("--rounds", type=int, default=None)
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()

rounds = args.rounds or (3 if args.fast else 10)

results = {}
for name in strategy_names():
    print(f"\n=== {name} ===")
    cfg = FLConfig(strategy=name, n_clients=10,
                   n_train=600 if args.fast else 1500, n_test=300,
                   batch_size=10, lr=0.0025,
                   local_epochs=1 if args.fast else 2,
                   mh_pop=4 if args.fast else 6,
                   mh_generations=2 if args.fast else 3,
                   max_rounds=rounds, tau=0.70, device=args.device)
    result = build_experiment(cfg).run(verbose=True)
    s = result.summary(fedavg_rounds=rounds)
    results[name] = {
        "rounds": s["rounds"],
        "acc": s["final_acc"],
        "loss": s["final_loss"],
        "uplink_mb": s["comm"]["uplink_bytes"] / 1e6,
        "norm_cost": s[f"normalized_cost_vs_fedavg{rounds}"],
    }

print("\n--- paper Figs. 4-6 analogue (synthetic data) ---")
print(f"{'strategy':10s} {'rounds':>6s} {'acc':>7s} {'loss':>7s} "
      f"{'uplinkMB':>9s} {'normcost':>9s}")
for k, v in sorted(results.items(), key=lambda kv: -kv[1]["acc"]):
    print(f"{k:10s} {v['rounds']:6d} {v['acc']:7.3f} {v['loss']:7.3f} "
          f"{v['uplink_mb']:9.2f} {v['norm_cost']:9.4f}")
