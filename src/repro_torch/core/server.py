"""FL server: strategy definitions and aggregation (paper Algorithms 2/3).

``FedAvg``  — clients upload weights; server averages (Alg. 2).
``FedX``    — clients upload a 4-byte score; server fetches the best
              client's weights and adopts them as the global model
              (Alg. 3: ServerRun + GetBestModel).  X is the client-side
              meta-heuristic (BWO in this port so far).

The port runs the **sequential** round engine: one client after another,
on the device of the server's key, with one device->host sync per round
(the scores).  The batched engine, fused rounds and pipelined blocks are
still to be ported (ROADMAP.md, queue 1, items 8-9): ``engine="auto"``
resolves to ``"sequential"``, ``"batched"`` raises, and
``rounds_per_dispatch`` / ``pipeline_blocks`` resolve as the reference
resolves them on its sequential engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch import random, tree
from repro_torch.core.client import ClientHP, Task, make_client_update
from repro_torch.core.comm import CommMeter
from repro_torch.core.knobs import (parse_pipeline_blocks,
                                    parse_rounds_per_dispatch,
                                    validate_engine)
from repro_torch.metaheuristics import REGISTRY, Metaheuristic


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str                         # fedavg | fedbwo
    mh: Optional[Metaheuristic]       # None => FedAvg
    client_ratio: float = 1.0         # C (FedAvg participation ratio)

    @property
    def is_fedx(self) -> bool:
        return self.mh is not None


def get_strategy(name: str, client_ratio: float = 1.0, **mh_kw) -> Strategy:
    name = name.lower()
    if name == "fedavg":
        return Strategy("fedavg", None, client_ratio)
    if name.startswith("fed") and name[3:] in REGISTRY:
        return Strategy(name, REGISTRY[name[3:]](**mh_kw), 1.0)
    raise KeyError(f"unknown strategy {name!r}")


class Server:
    """Orchestrates FL rounds over in-process simulated clients, on the
    device of ``rng`` (the server's key) and of the client data."""

    def __init__(self, task: Task, strategy: Strategy, hp: ClientHP,
                 client_data: Sequence[Any], rng: torch.Tensor,
                 model_bytes: Optional[int] = None, engine: str = "auto",
                 rounds_per_dispatch: Union[int, str] = 1,
                 pipeline_blocks: Union[bool, str] = "auto"):
        validate_engine(engine)
        if engine == "batched":
            raise NotImplementedError(
                "engine='batched' is not ported yet (ROADMAP.md, queue 1, "
                "item 8); the port runs engine='sequential'")
        rpd = parse_rounds_per_dispatch(rounds_per_dispatch)
        pipe = parse_pipeline_blocks(pipeline_blocks)
        self.task = task
        self.strategy = strategy
        self.hp = hp
        self.client_data = list(client_data)
        self.n_clients = len(client_data)
        empty = [k for k, d in enumerate(self.client_data)
                 if any(l.dim() and l.shape[0] == 0 for l in tree.leaves(d))]
        if empty:
            raise ValueError(
                f"client shards {empty} are empty (0 batches) — a client "
                f"with no data can neither train nor score; extreme "
                f"Dirichlet skew can starve clients, so drop empty "
                f"shards or repartition (larger alpha / fewer clients / "
                f"smaller batch size) before constructing the Server")
        rng, pkey = random.split(rng)
        self.rng = rng
        self.device = rng.device
        self.global_params = task.init_params(pkey)
        if model_bytes is None:
            model_bytes = sum(l.numel() * l.element_size()
                              for l in tree.leaves(self.global_params))
        self.meter = CommMeter(model_bytes=model_bytes,
                               n_clients=self.n_clients)
        # the sequential engine: no batched round program to fuse or to
        # overlap, so "auto" resolves to one round per dispatch and no
        # pipeline; a forced value is kept, and runs round by round
        self.engine = "sequential"
        self.rounds_per_dispatch = 1 if rpd is None else rpd
        self.pipeline_blocks = bool(pipe) if pipe is not None else False
        self.rounds_completed = 0
        self._update = make_client_update(task, hp, strategy.mh)

    # ------------------------------------------------------------ round --
    def run_round(self) -> dict:
        keys = random.split(self.rng, self.n_clients + 2)
        self.rng, sel_key, ckeys = keys[0], keys[1], keys[2:]
        self.rounds_completed += 1
        if self.strategy.is_fedx:
            # every client trains + refines, uploads only its score
            scores, params_list = [], []
            for k in range(self.n_clients):
                score, params = self._update(self.global_params,
                                             self.client_data[k], ckeys[k])
                scores.append(score)
                params_list.append(params)
            # one host sync per round, after all clients have run
            scores = torch.stack(scores).cpu().numpy()
            best = int(scores.argmin())
            # GetBestModel: one full-model transfer from the winner only
            self.global_params = params_list[best]
            self.meter.record_fedx_round(fetched_model=True)
            return {"best_client": best, "score": float(scores[best]),
                    "scores": [float(s) for s in scores],
                    "engine": "sequential"}
        # ---- FedAvg ----
        m = max(int(self.strategy.client_ratio * self.n_clients), 1)
        sel = random.choice(sel_key, self.n_clients, (m,)).tolist()
        scores, new_params = [], []
        for k in sel:
            score, params = self._update(self.global_params,
                                         self.client_data[k], ckeys[k])
            scores.append(score)
            new_params.append(params)
        self.global_params = tree.map(
            lambda *xs: torch.stack(xs).mean(0), *new_params)
        scores = torch.stack(scores).cpu().numpy()
        self.meter.record_fedavg_round(m)
        return {"participants": sel,
                "scores": [float(s) for s in scores],
                "engine": "sequential"}

    # ------------------------------------------------------------- eval --
    @torch.no_grad()
    def evaluate(self, eval_data) -> Tuple[float, float]:
        loss, acc = self.task.loss_fn(self.global_params, eval_data)
        # one host copy for both scalars
        loss, acc = torch.stack([loss, acc]).cpu().numpy()
        return float(loss), float(acc)
