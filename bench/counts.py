"""The benchmark's own arithmetic: parameter counts, a round's model
FLOPs, ``bwo_evolve``'s bytes bound and the card's peaks.  Everything is
computed from the configuration's and the traffic mix's numbers.
"""
from __future__ import annotations

import importlib
import math

from bench.reference.fl import BWO

# NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor cores
# (the port runs cuBLAS and cuDNN with TF32 off) and HBM3 bandwidth.
PEAKS = {"float32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def model_module(cfg: dict):
    return importlib.import_module(f"bench.models.{cfg['model']}")


def n_params(cfg: dict) -> int:
    """D, the genome's length."""
    return sum(math.prod(s) for _, s in model_module(cfg).layout(cfg))


def forward_flops(cfg: dict) -> int:
    """One sample's forward pass: 2 x multiply-adds of every product."""
    return model_module(cfg).forward_flops(cfg)


def n_participants(traffic: dict) -> int:
    if traffic["strategy"] == "fedavg":
        return max(int(traffic["client_ratio"] * traffic["n_clients"]), 1)
    return traffic["n_clients"]


def batches_per_client(traffic: dict) -> int:
    return traffic["n_train"] // traffic["n_clients"] // traffic["batch_size"]


def eval_rounds(traffic: dict, first: int, n_rounds: int) -> int:
    """How many of the rounds ``first .. first + n_rounds - 1`` (whole
    blocks of ``rounds_per_dispatch``) evaluate: every ``eval_every``-th
    round and each block's last."""
    R, every = traffic["rounds_per_dispatch"], traffic["eval_every"]
    return sum(1 for r in range(first, first + n_rounds)
               if (r + 1) % every == 0 or (r + 1) % R == 0)


def round_samples(traffic: dict) -> dict:
    """Samples a round pushes through the model, by kind (no evaluation):
    ``trained`` (a forward and a backward each), ``fitness`` (a forward:
    the fitness batches, once for FedAvg's score, for every member seeded
    and every child of every generation for FedBWO)."""
    B = traffic["batch_size"]
    clients = n_participants(traffic)
    trained = clients * batches_per_client(traffic) * B * \
        traffic["local_epochs"]
    fit = traffic["fitness_batches"] * B
    if traffic["strategy"] == "fedbwo":
        members = traffic["mh_pop"] * (1 + traffic["mh_generations"])
    else:
        members = 1
    return {"trained": trained, "fitness": clients * members * fit}


def rounds_flops(cfg: dict, traffic: dict, first: int, n_rounds: int) -> int:
    """Model FLOPs of ``n_rounds`` rounds from round ``first``: 3 forward
    passes a trained sample, 1 a fitness and an evaluation sample."""
    f = forward_flops(cfg)
    s = round_samples(traffic)
    per_round = (3 * s["trained"] + s["fitness"]) * f
    return n_rounds * per_round + eval_rounds(traffic, first, n_rounds) * \
        traffic["n_test"] * f


def expected_distinct(n_par: int, draws: int) -> float:
    """Expected number of distinct values among ``draws`` uniform draws
    from ``n_par``."""
    return n_par * (1.0 - (1.0 - 1.0 / n_par) ** draws)


def bwo_evolve_bytes(rows: int, D: int, parent_rows: float,
                     bit_words: int = None) -> float:
    """The least bytes one ``bwo_evolve`` launch moves: each distinct
    parent row read once (D floats), both bit planes' ``bit_words`` words
    a row (D by default: the kernel never reads the padding past D), the
    children written once (D floats a row)."""
    bit_words = D if bit_words is None else bit_words
    return 4.0 * (parent_rows * D + 2 * rows * bit_words + rows * D)


def bwo_launch_bytes(cfg: dict, traffic: dict) -> float:
    """One generation's launch at the mix's sizes: clients x pop rows; the
    parents a client can draw are its fittest ``procreate_frac``, of which
    its 2 x pop draws reach the expected distinct count."""
    P = traffic["mh_pop"]
    n_par = max(2, int(P * BWO["procreate_frac"]))
    clients = traffic["n_clients"]
    return bwo_evolve_bytes(clients * P, n_params(cfg),
                            clients * expected_distinct(n_par, 2 * P))
