"""FL server: strategy definitions and aggregation (paper Algorithms 2/3).

``FedAvg``  — clients upload weights; server averages (Alg. 2).
``FedX``    — clients upload a 4-byte score; server fetches the best
              client's weights and adopts them as the global model
              (Alg. 3: ServerRun + GetBestModel).  X ∈ {BWO, PSO, GWO,
              SCA, AVO} only changes the client-side meta-heuristic.

Two round engines run the same protocol, on the device of the server's
key, with identical ``CommMeter`` accounting and one device->host sync per
round:

``batched``    — every client's update in one program over a leading
                 client axis (:class:`repro_torch.core.engine.
                 BatchedRoundEngine`): under ``torch.func.vmap`` on the
                 card, so each op, the BWO kernel included, is issued
                 once for all clients.  Ragged (Dirichlet) client
                 datasets batch too, by pad+mask stacking.
``sequential`` — one client after another; the fallback for genuinely
                 unstackable client datasets, the CPU's engine for conv
                 tasks, and the baseline of the engine-parity tests.

Fused rounds and pipelined blocks are still to be ported (ROADMAP.md,
queue 1, item 9): ``rounds_per_dispatch="auto"`` resolves to 1 on both
engines (the reference's batched engine resolves it to 5), and a forced
R > 1 raises on the batched engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch import random, tree
from repro_torch.core.client import ClientHP, Task, make_update
from repro_torch.core.comm import CommMeter
from repro_torch.core.engine import BatchedRoundEngine, task_uses_conv
from repro_torch.core.knobs import (parse_pipeline_blocks,
                                    parse_rounds_per_dispatch,
                                    validate_engine)
from repro_torch.metaheuristics import REGISTRY, Metaheuristic


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str                         # fedavg | fedbwo | fedpso | ...
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
    device of ``rng`` (the server's key) and of the client data.

    ``engine``: "auto" (batched when the client datasets stack — ragged
    batch counts are padded and masked — except that on the CPU conv
    tasks stay sequential, as in the reference), "batched" (forced; an
    unstackable dataset raises) or "sequential".

    ``rounds_per_dispatch`` / ``pipeline_blocks``: "auto" resolves to one
    round per dispatch and no pipeline on both engines until fused rounds
    are ported (ROADMAP.md, queue 1, item 9).  On the sequential engine a
    forced value is kept and runs round by round, as in the reference; on
    the batched engine a forced R > 1 raises.
    """

    def __init__(self, task: Task, strategy: Strategy, hp: ClientHP,
                 client_data: Sequence[Any], rng: torch.Tensor,
                 model_bytes: Optional[int] = None, engine: str = "auto",
                 rounds_per_dispatch: Union[int, str] = 1,
                 pipeline_blocks: Union[bool, str] = "auto"):
        validate_engine(engine)
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
        self._engine: Optional[BatchedRoundEngine] = None
        if engine != "sequential" and self.n_clients > 0:
            # the reference's policy: on the CPU, conv tasks run faster
            # client by client than as grouped convolutions over the
            # client axis, so engine="auto" keeps them sequential there
            want = engine == "batched" or not (
                self.device.type == "cpu"
                and task_uses_conv(
                    task, self.global_params,
                    tree.map(lambda a: a[0], self.client_data[0])))
            if want:
                try:
                    self._engine = BatchedRoundEngine(
                        task, strategy, hp, self.client_data, self.device)
                except ValueError:
                    if engine == "batched":
                        raise
        self.engine = "batched" if self._engine is not None else "sequential"
        if self._engine is not None and rpd is not None and rpd > 1:
            raise NotImplementedError(
                f"rounds_per_dispatch={rpd} fuses rounds on the batched "
                f"engine, which is not ported yet (ROADMAP.md, queue 1, "
                f"item 9); pass 1 or 'auto'")
        # no fused round program yet: "auto" is one round per dispatch and
        # no pipeline on either engine; the sequential engine keeps a
        # forced value and runs it round by round
        self.rounds_per_dispatch = 1 if rpd is None else rpd
        self.pipeline_blocks = bool(pipe) if pipe is not None else False
        self.rounds_completed = 0
        self._update = None
        if self._engine is None:
            self._update = make_update(task, hp, strategy.mh)

    # ------------------------------------------------------------ round --
    def run_round(self) -> dict:
        keys = random.split(self.rng, self.n_clients + 2)
        self.rng, sel_key, ckeys = keys[0], keys[1], keys[2:]
        self.rounds_completed += 1
        if self._engine is not None:
            return self._run_round_batched(sel_key, ckeys)
        return self._run_round_sequential(sel_key, ckeys)

    def _run_round_batched(self, sel_key, ckeys) -> dict:
        if self.strategy.is_fedx:
            new_params, scores, best = self._engine.fedx_round(
                self.global_params, ckeys)
            self.global_params = new_params
            self.meter.record_fedx_round(fetched_model=True)
            # the round's single device->host sync
            scores, best = _fetch(scores, best)
            best = int(best[0])
            return {"best_client": best, "score": float(scores[best]),
                    "scores": [float(s) for s in scores],
                    "engine": "batched"}
        new_params, scores, sel = self._engine.fedavg_round(
            self.global_params, sel_key, ckeys)
        self.global_params = new_params
        self.meter.record_fedavg_round(self._engine.n_participants)
        # the round's single device->host sync; scores align with the
        # participants list
        sel, scores = _fetch(sel, scores)
        return {"participants": [int(k) for k in sel],
                "scores": [float(s) for s in scores],
                "engine": "batched"}

    def _run_round_sequential(self, sel_key, ckeys) -> dict:
        if self.strategy.is_fedx:
            # every client trains + refines, uploads only its score
            scores, params_list = [], []
            for k in range(self.n_clients):
                score, params = self._update(self.global_params,
                                             self.client_data[k], None,
                                             ckeys[k])
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
                                         self.client_data[k], None, ckeys[k])
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


def _fetch(*tensors):
    """Several device tensors in one device->host copy: each flattened
    into one float64 buffer (exact for float32 and for small ints), split
    again on the host as numpy arrays."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()])
        i += t.numel()
    return out
