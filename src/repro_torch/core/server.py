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

On top of the batched engine, ``rounds_per_dispatch > 1`` runs whole
*blocks* of rounds at once (``run_block``,
:func:`repro_torch.core.engine.make_fused_rounds`): the threefry key
schedule moves to the device bit for bit, eval runs at a cadence inside
the block, and the host pays one dispatch and one log copy per R rounds.
On the card a block is one replay of a captured CUDA graph.
``run_pipelined`` keeps two blocks in flight.  With ``spans`` on (the
default) each block also stamps its device spans
(:mod:`repro_torch.spans`), which ``finish_block`` fetches with the logs
and appends to the span log; ``dispatch_block``, ``finish_block`` and its
fetch are profiler ranges of those names on the host
(:func:`repro_torch.spans.host_range`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import random, spans as spanlog, tree
from repro_torch.core.client import ClientHP, Task, make_update
from repro_torch.core.comm import BlockTiming, CommMeter
from repro_torch.core.engine import (BatchedRoundEngine, pipeline_blocks,
                                     task_uses_conv)
from repro_torch.core.knobs import (DEFAULT_PIPELINE_DEPTH,
                                    DEFAULT_ROUNDS_PER_DISPATCH,
                                    parse_pipeline_blocks,
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


@dataclasses.dataclass
class PendingBlock:
    """A dispatched fused block: its stacked round logs (the block's own
    device tensors, still being computed) plus the host bookkeeping
    needed to finish it."""
    n_rounds: int
    round_offset: int         # server.rounds_completed before the block
    logs: Any                 # stacked per-round device tensors
    t_dispatched: float       # perf_counter timestamp at dispatch
    dispatch_s: float         # host time spent enqueueing the dispatch
    # on the card: recorded on the stream after the block's logs were
    # copied out; finish_block's copy waits for it, not for later blocks
    ready: Optional[Any] = None
    # the schema of the device spans in logs["spans"], if any
    span_schema: Optional[tuple] = None


@dataclasses.dataclass
class PipelineResult:
    """Outcome of :meth:`Server.run_pipelined`.

    ``infos`` covers every round that actually ran — including the rounds
    of any block that was already in flight when a stopping condition
    triggered (the one-block overshoot).  ``kept`` counts the leading
    infos up to and including the block that triggered the stop (``==
    len(infos)`` when nothing did); drivers trim their logs to
    ``infos[:kept]`` while the server's device state, round counter, and
    CommMeter ledger keep the overshoot rounds.
    """
    infos: List[dict]
    kept: int
    stopped: bool


class Server:
    """Orchestrates FL rounds over in-process simulated clients, on the
    device of ``rng`` (the server's key) and of the client data.

    ``engine``: "auto" (batched when the client datasets stack — ragged
    batch counts are padded and masked — except that on the CPU conv
    tasks stay sequential, as in the reference), "batched" (forced; an
    unstackable dataset raises) or "sequential".

    ``rounds_per_dispatch``: how many rounds one dispatch runs.  1 is one
    dispatch a round; R > 1 runs blocks of R rounds (``run_block``), one
    CUDA graph replay each on the card, with one host copy per block.
    "auto" resolves to 1 when the round engine is sequential (there is no
    batched block to fuse) and to ``knobs.DEFAULT_ROUNDS_PER_DISPATCH``
    (5) on the batched engine, as in the reference.

    ``pipeline_blocks``: keep two blocks in flight (``run_pipelined``), so
    the host finishes block k while the card runs block k+1.  "auto"
    turns it on exactly when there is a fused batched block to overlap
    (batched engine, ``rounds_per_dispatch > 1``); "on"/"off" force it
    (on the sequential engine "on" degrades to the serial block loop).

    ``spans``: stamp each fused block's device spans (the batched
    engine's, :mod:`repro_torch.spans`); off, a block captures no stamp
    and its logs hold no ``spans`` entry, with the same results.
    """

    def __init__(self, task: Task, strategy: Strategy, hp: ClientHP,
                 client_data: Sequence[Any], rng: torch.Tensor,
                 model_bytes: Optional[int] = None, engine: str = "auto",
                 rounds_per_dispatch: Union[int, str] = 1,
                 pipeline_blocks: Union[bool, str] = "auto",
                 spans: bool = True):
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
                        task, strategy, hp, self.client_data, self.device,
                        spans=spans)
                except ValueError:
                    if engine == "batched":
                        raise
        self.engine = "batched" if self._engine is not None else "sequential"
        # auto: fuse only where there is a batched round to fuse (the CPU's
        # conv policy has already resolved to sequential)
        if rpd is None:
            rpd = (DEFAULT_ROUNDS_PER_DISPATCH
                   if self._engine is not None else 1)
        self.rounds_per_dispatch = rpd
        # auto: overlap exactly when there is a fused batched block to
        # overlap; "on" without a batched engine degrades to the serial
        # block loop inside run_pipelined
        if pipe is None:
            pipe = self._engine is not None and rpd > 1
        self.pipeline_blocks = bool(pipe)
        self.rounds_completed = 0
        self._update = None
        if self._engine is None:
            self._update = make_update(task, hp, strategy.mh)
        # finish_block copies a block's logs on a stream of its own, so the
        # copy waits for that block and not for the one dispatched after it
        self._fetch_stream = None
        if self._engine is not None and self.device.type == "cuda":
            self._fetch_stream = torch.cuda.Stream(self.device)

    # ------------------------------------------------------------ round --
    def run_round(self) -> dict:
        keys = random.split(self.rng, self.n_clients + 2)
        self.rng, sel_key, ckeys = keys[0], keys[1], keys[2:]
        self.rounds_completed += 1
        if self._engine is not None:
            return self._run_round_batched(sel_key, ckeys)
        return self._run_round_sequential(sel_key, ckeys)

    # ------------------------------------------------------------ block --
    def run_block(self, n_rounds: Optional[int] = None, eval_data=None,
                  eval_every: int = 1) -> List[dict]:
        """Run ``n_rounds`` (default: ``rounds_per_dispatch``) rounds as ONE
        fused block (engine="batched") and return one info dict per round,
        in ``run_round``'s format plus ``eval_loss`` / ``eval_acc`` on the
        rounds the ``eval_every`` cadence (and the block's last round)
        evaluated on the device.

        The block carries ``(global_params, rng)`` across rounds with the
        server's key schedule derived on the device, so a block is
        bit-identical to ``n_rounds`` ``run_round`` calls on the CPU,
        including the CommMeter ledger, rebuilt per round by
        ``CommMeter.record_rounds``.  The whole block costs one
        device->host copy (the stacked round logs).

        On the sequential engine this degrades to a loop of ``run_round``
        and the cadenced ``evaluate``, with the same return shape.
        """
        n_rounds = int(n_rounds or self.rounds_per_dispatch)
        if self._engine is None:
            infos = []
            for i in range(n_rounds):
                info = self.run_round()
                if eval_data is not None and eval_every > 0 and (
                        self.rounds_completed % eval_every == 0
                        or i == n_rounds - 1):
                    loss, acc = self.evaluate(eval_data)
                    info["eval_loss"], info["eval_acc"] = loss, acc
                infos.append(info)
            return infos
        return self.finish_block(
            self.dispatch_block(n_rounds, eval_data, eval_every))

    # --------------------------------------------------------- pipeline --
    def dispatch_block(self, n_rounds: Optional[int] = None, eval_data=None,
                       eval_every: int = 1) -> PendingBlock:
        """Dispatch one fused block WITHOUT fetching its logs.

        On the card the block is enqueued (a graph replay and the copies
        around it) and this returns at once; ``global_params``, ``rng``
        and ``rounds_completed`` advance at once, which lets the *next*
        ``dispatch_block`` enqueue before this block has run.  Pair with
        :meth:`finish_block`, in dispatch order, to copy the logs, record
        the meter, and build the info dicts.  Requires the batched engine.
        """
        if self._engine is None:
            raise RuntimeError(
                "dispatch_block requires the batched engine; the "
                "sequential fallback has no async block dispatch to "
                "pipeline — use run_block, which degrades gracefully")
        n_rounds = int(n_rounds or self.rounds_per_dispatch)
        t0 = time.perf_counter()
        with spanlog.host_range("dispatch_block"):
            offset = self.rounds_completed
            params, rng, logs = self._engine.run_block(
                self.global_params, self.rng, n_rounds, eval_batch=eval_data,
                eval_every=eval_every, round_offset=offset)
            self.global_params, self.rng = params, rng
            self.rounds_completed += n_rounds
            ready = None
            if self._fetch_stream is not None:
                ready = torch.cuda.Event()
                ready.record()
        return PendingBlock(n_rounds=n_rounds, round_offset=offset,
                            logs=logs, t_dispatched=t0,
                            dispatch_s=time.perf_counter() - t0,
                            ready=ready,
                            span_schema=self._engine.block_spans)

    def finish_block(self, pending: PendingBlock) -> List[dict]:
        """Finish a dispatched block: record its rounds on the meter, copy
        the stacked logs to the host (the block's one device->host copy;
        under the pipeline the next block runs meanwhile), rebuild the
        per-round info dicts, append the block's device spans (fetched in
        the same copy) to the span log, and append a
        :class:`~repro_torch.core.comm.BlockTiming` to the meter's block
        ledger."""
        with spanlog.host_range("finish_block"):
            return self._finish_block(pending)

    def _finish_block(self, pending: PendingBlock) -> List[dict]:
        n_rounds = pending.n_rounds
        if self.strategy.is_fedx:
            self.meter.record_rounds(self.strategy, n_rounds,
                                     fetched_model=True)
        else:
            self.meter.record_rounds(
                self.strategy, n_rounds,
                n_participants=self._engine.n_participants)
        names = sorted(pending.logs)
        t0 = time.perf_counter()
        # the block's single device->host copy
        with spanlog.host_range("fetch"):
            if pending.ready is None:
                host = _fetch(*(pending.logs[k] for k in names))
            else:
                with torch.cuda.stream(self._fetch_stream):
                    self._fetch_stream.wait_event(pending.ready)
                    host = _fetch(*(pending.logs[k] for k in names))
        t1 = time.perf_counter()
        out = {k: h.reshape(pending.logs[k].shape)
               for k, h in zip(names, host)}
        if "spans" in out:
            spanlog.record_block(self._engine.span_owner,
                                 pending.round_offset, pending.span_schema,
                                 out.pop("spans"))
        infos = self._block_infos(out, n_rounds)
        t2 = time.perf_counter()
        self.meter.record_block_timing(BlockTiming(
            n_rounds=n_rounds, dispatch_s=pending.dispatch_s,
            sync_s=t1 - t0, process_s=t2 - t1,
            total_s=t2 - pending.t_dispatched))
        return infos

    def _block_infos(self, out, n_rounds: int) -> List[dict]:
        """``run_round``-shaped info dicts rebuilt on the host from a fused
        block's fetched logs."""
        infos = []
        for r in range(n_rounds):
            scores = out["scores"][r]
            if self.strategy.is_fedx:
                best = int(out["best"][r])
                info = {"best_client": best, "score": float(scores[best]),
                        "scores": [float(s) for s in scores],
                        "engine": "fused"}
            else:
                # FedAvg scores align with the participants list
                info = {"participants": [int(k)
                                         for k in out["participants"][r]],
                        "scores": [float(s) for s in scores],
                        "engine": "fused"}
            if "eval_loss" in out and not math.isnan(
                    float(out["eval_loss"][r])):
                info["eval_loss"] = float(out["eval_loss"][r])
                info["eval_acc"] = float(out["eval_acc"][r])
            infos.append(info)
        return infos

    def run_pipelined(self, rounds: int, eval_data=None,
                      eval_every: int = 1,
                      stop_fn: Optional[Callable[[dict], bool]] = None,
                      block_rounds: Optional[int] = None,
                      depth: int = DEFAULT_PIPELINE_DEPTH) -> PipelineResult:
        """Run ``rounds`` rounds as double-buffered fused blocks.

        Blocks of ``block_rounds`` (default ``rounds_per_dispatch``) rounds
        go through :func:`repro_torch.core.engine.pipeline_blocks`: block
        ``k+1`` is enqueued before block ``k``'s logs are fetched, so the
        host's log copy, info rebuild, CommMeter recording and ``stop_fn``
        checks of block ``k`` overlap block ``k+1``'s run on the card.
        The result equals a serial ``run_block`` loop's: the pipeline
        reorders host work, not device work.

        ``stop_fn(info)`` is called once per finished round, in round
        order; when it returns True no further block is dispatched, but
        the block already in flight completes (its rounds run, its meter
        entries land) — a worst-case overshoot of ``(depth - 1) *
        block_rounds`` rounds.  See :class:`PipelineResult` for the trim
        contract.  A trailing partial block (``rounds`` not a multiple of
        the block size) is a second block shape; ``run_federated`` passes
        a multiple and runs leftovers on the single-round path.

        On the sequential engine this degrades to a serial ``run_block``
        loop: same result shape, no overlap and no overshoot.
        """
        rounds = int(rounds)
        block = int(block_rounds or self.rounds_per_dispatch)
        sizes = [block] * (rounds // block)
        if rounds % block:
            sizes.append(rounds % block)
        should_stop = None
        if stop_fn is not None:
            def should_stop(infos):
                return any(stop_fn(i) for i in infos)
        if self._engine is None:
            infos, stopped = [], False
            for n in sizes:
                out = self.run_block(n, eval_data, eval_every)
                infos.extend(out)
                if should_stop is not None and should_stop(out):
                    stopped = True
                    break
            return PipelineResult(infos=infos, kept=len(infos),
                                  stopped=stopped)
        results, kept_blocks, stopped = pipeline_blocks(
            lambda n: self.dispatch_block(n, eval_data, eval_every),
            self.finish_block, sizes, depth=depth,
            should_stop=should_stop)
        return PipelineResult(
            infos=[i for blk in results for i in blk],
            kept=sum(len(blk) for blk in results[:kept_blocks]),
            stopped=stopped)

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
