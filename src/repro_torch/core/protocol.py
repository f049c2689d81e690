"""Federated training driver with the paper's stopping conditions (§IV-D):

1. no significant improvement for ``t`` consecutive rounds,
2. accuracy above threshold ``tau``,
3. round limit reached.

The port drives one round at a time on either engine (the reference's
single-round branch); fused and pipelined blocks are still to be ported
(ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List

from repro_torch.core.server import Server
from repro_torch.device import synchronize


@dataclasses.dataclass
class StopConditions:
    max_rounds: int = 30          # paper: 30 global epochs
    patience: int = 5             # paper: t = 5
    tau: float = 0.70             # paper: tau = 70%
    min_delta: float = 1e-3


@dataclasses.dataclass
class RoundLog:
    round: int
    test_loss: float
    test_acc: float
    wall_time_s: float
    info: Dict[str, Any]
    round_time_s: float = 0.0    # run_round only, synchronized on the device


def run_federated(server: Server, eval_data, stop: StopConditions,
                  verbose: bool = False,
                  eval_every: int = 1) -> List[RoundLog]:
    """Drive ``server`` to a stopping condition.

    ``eval_every``: evaluate the global model every k-th round (1 =
    every round, the paper's cadence).  Skipped rounds log NaN
    loss/accuracy and don't advance the patience counter; the last round
    always evaluates.
    """
    logs: List[RoundLog] = []
    best_acc, stale = -1.0, 0
    rnd, stop_now = 0, False

    def check_stop(acc):
        nonlocal best_acc, stale
        if math.isnan(acc):
            return False
        if acc > best_acc + stop.min_delta:
            best_acc, stale = acc, 0
        else:
            stale += 1
        return acc >= stop.tau or stale >= stop.patience

    while rnd < stop.max_rounds and not stop_now:
        t0 = time.perf_counter()
        info = server.run_round()
        # wait for the new global model so round_time_s measures device
        # work, not the enqueue
        synchronize(server.device)
        t_round = time.perf_counter() - t0
        if (rnd + 1) % max(eval_every, 1) == 0 \
                or rnd == stop.max_rounds - 1:
            loss, acc = server.evaluate(eval_data)
        else:
            loss, acc = float("nan"), float("nan")
        dt = time.perf_counter() - t0
        logs.append(RoundLog(rnd, loss, acc, dt, info, t_round))
        if verbose:
            print(f"  round {rnd:3d}  loss={loss:.4f} acc={acc:.4f} "
                  f"({dt:.2f}s) {info if rnd < 2 else ''}")
        stop_now = check_stop(acc)
        rnd += 1
    return logs
