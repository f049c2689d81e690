"""Federated training driver with the paper's stopping conditions (§IV-D):

1. no significant improvement for ``t`` consecutive rounds,
2. accuracy above threshold ``tau``,
3. round limit reached.

When the server runs with ``rounds_per_dispatch > 1`` on the batched
engine, the driver runs *blocks* of rounds through ``Server.run_block``:
one dispatch (on the card, one CUDA graph replay) and one device->host
copy per block, with eval inside the block at the ``eval_every`` cadence.
Stopping conditions are still checked per evaluated round, but a block is
atomic: if tau/patience triggers mid-block, the rest of that block has
already run (and is logged and accounted) — the fused path trades
stopping granularity for dispatch overhead.

With ``server.pipeline_blocks`` on, the blocks are also double-buffered
(``Server.run_pipelined``): block k+1 is dispatched before block k's logs
are fetched, so the host's log processing and stopping checks overlap the
card's run.  The cost is one more block of stopping overshoot: when
tau/patience triggers in block k, block k+1 is already in flight and
completes (it advances the server's params, round counter and meter), but
its rounds are trimmed from the returned logs — the log list still ends
at the triggering block, as the serial fused driver's does.
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
    always evaluates.  On the fused path the cadence runs *inside* the
    block, and each block's last round always evaluates, so stopping
    decisions never act on stale accuracy.
    """
    logs: List[RoundLog] = []
    best_acc, stale = -1.0, 0
    rpd = int(getattr(server, "rounds_per_dispatch", 1))
    fused = rpd > 1 and getattr(server, "engine", "sequential") == "batched"
    pipelined = fused and bool(getattr(server, "pipeline_blocks", False))
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
        if pipelined and stop.max_rounds - rnd >= rpd:
            # double-buffered: all remaining full blocks in one pipelined
            # drive; block k's log processing and stopping checks overlap
            # block k+1's run.  If a stop triggers, the in-flight block
            # completes (one-block overshoot on the server's state and
            # meter) but its rounds are trimmed from the logs; leftover
            # rounds (< rpd) fall through to the single-round path below.
            n = ((stop.max_rounds - rnd) // rpd) * rpd
            t0 = time.perf_counter()
            res = server.run_pipelined(
                n, eval_data, eval_every=eval_every,
                stop_fn=lambda info: check_stop(
                    info.get("eval_acc", float("nan"))))
            synchronize(server.device)
            dt = (time.perf_counter() - t0) / max(len(res.infos), 1)
            for info in res.infos[:res.kept]:
                loss = info.pop("eval_loss", float("nan"))
                acc = info.pop("eval_acc", float("nan"))
                logs.append(RoundLog(rnd, loss, acc, dt, info, dt))
                if verbose:
                    print(f"  round {rnd:3d}  loss={loss:.4f} "
                          f"acc={acc:.4f} ({dt:.2f}s amortized, "
                          f"pipelined) {info if rnd < 2 else ''}")
                rnd += 1
            stop_now = res.stopped
        elif fused and stop.max_rounds - rnd >= rpd:
            # one dispatch and one log copy for the whole block; leftover
            # rounds (< rpd) fall through to the single-round path below,
            # so only one block shape is built
            t0 = time.perf_counter()
            infos = server.run_block(rpd, eval_data, eval_every=eval_every)
            synchronize(server.device)
            dt = time.perf_counter() - t0
            for info in infos:
                loss = info.pop("eval_loss", float("nan"))
                acc = info.pop("eval_acc", float("nan"))
                logs.append(RoundLog(rnd, loss, acc, dt / rpd, info,
                                     dt / rpd))
                if verbose:
                    print(f"  round {rnd:3d}  loss={loss:.4f} "
                          f"acc={acc:.4f} ({dt / rpd:.2f}s amortized) "
                          f"{info if rnd < 2 else ''}")
                stop_now = check_stop(acc) or stop_now
                rnd += 1
        else:
            t0 = time.perf_counter()
            info = server.run_round()
            # wait for the new global model so round_time_s measures
            # device work, not the enqueue
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
