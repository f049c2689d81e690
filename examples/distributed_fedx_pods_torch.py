"""The paper's protocol as a multi-process collective schedule, in the
PyTorch port: 8 processes (gloo ranks) stand in for 8 pods/clients.
Local training runs with ZERO collectives; per round the only traffic is
the 4-byte-score all-gather + the winner's weights broadcast from its rank
— versus FedAvg's full-model all-reduce every round.  The data, the keys
and the initial weights are those of ``examples/distributed_fedx_pods.py``
(the port's threefry draws JAX's numbers).

    PYTHONPATH=src python examples/distributed_fedx_pods_torch.py
    PYTHONPATH=src python examples/distributed_fedx_pods_torch.py --device cpu

Every rank sits on the card (cuda:0) unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch import random, tree
from repro_torch.core.client import ClientHP, Task
from repro_torch.core.comm import fedavg_round_bytes, fedx_round_bytes
from repro_torch.core.distributed import make_fedavg_round, make_fedx_round
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.metaheuristics import bwo

N = 8


def init_params(rng):
    k1, k2 = random.split(rng)
    return {"w1": random.normal(k1, (16, 32)) * 0.2,
            "w2": random.normal(k2, (32, 4)) * 0.2}


def loss_fn(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"])
    logits = h @ params["w2"]
    lp = torch.log_softmax(logits, -1)
    nll = -torch.take_along_dim(lp, batch["y"][:, None], -1).mean()
    return nll, (logits.argmax(-1) == batch["y"]).float().mean()


def client(rank, device, rounds):
    """One rank: its client's data and key, FedBWO then FedAvg for
    ``rounds`` rounds each; returns each round's best score and the bytes
    its collectives carried."""
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dev = torch.device(device)
    mesh = make_host_mesh(N, device_type=dev.type)
    rng = random.PRNGKey(0, dev)
    w_true = random.normal(random.PRNGKey(9, dev), (16, 4))
    x = random.normal(rng, (N, 8, 32, 16))
    data = {"x": x[rank:rank + 1], "y": (x @ w_true).argmax(-1)[rank:rank + 1]}
    keys = random.split(rng, N)[rank:rank + 1]
    task = Task(init_params, loss_fn)
    hp = ClientHP(local_epochs=2, mh_pop=6, mh_generations=3, lr=0.1)
    log = []
    for label, rnd in [("FedBWO", make_fedx_round(task, hp, bwo(), mesh)),
                       ("FedAvg", make_fedavg_round(task, hp, mesh))]:
        params = task.init_params(random.PRNGKey(3, dev))
        for r in range(rounds):
            params, scores = rnd(params, data, keys)
            log.append((label, r, float(scores.min()), dict(rnd.traffic)))
    nbytes = sum(l.numel() * l.element_size() for l in tree.leaves(params))
    return nbytes, log


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device: pass --device cpu")
    nbytes, log = run_ranks(N, client, args.device, args.rounds)[0]
    print(f"mesh: ({N},) over 'clients', one gloo rank per "
          f"federation client/pod, on {args.device}")
    for label, r, best, traffic in log:
        if r == 0:
            print(f"\n{label}: model = {nbytes:,} bytes")
        comm = (fedx_round_bytes(N, nbytes) if label == "FedBWO"
                else fedavg_round_bytes(1.0, N, nbytes))
        print(f"  round {r}: best_score={best:.4f} logical uplink={comm:,}B "
              f"(collectives: {traffic})")


if __name__ == "__main__":
    main()
