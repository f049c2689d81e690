"""Batched FL round engine: one program per round over every client.

The port's counterpart of ``repro.core.engine``'s single-round engine.
The sequential ``Server`` loop runs one client after another; this module
runs the *entire round* — every selected client's local update plus the
server aggregation — as one program over a leading client axis:

* client datasets are stacked along a leading ``(n_clients, ...)`` axis
  (:func:`stack_clients`); ragged datasets (Dirichlet splits) are
  zero-padded to the longest client and a ``(n_clients, n_batches)``
  validity mask rides along, threaded through the client update
  (:func:`~repro_torch.core.client.make_update`) so padded batches
  contribute no SGD step and no fitness term;
* the client update runs across that axis under
  ``torch.func.vmap`` (each op issued once for all clients; the BWO
  kernel launched once per generation for every client) or a Python
  loop, selected by the ``vectorize`` knob on
  :class:`~repro_torch.core.client.ClientHP` (:func:`resolve_vectorize`);
* FedAvg with ``client_ratio < 1`` samples its ``m`` participants and
  gathers only their shards before the round (sample-then-stack);
* the FedX argmin runs on the device; the loop's winner reduction is a
  streaming ``torch.where``, so it holds O(2 x model) weights instead of
  O(n_clients x model), and FedAvg's loop keeps a running mean the same
  way;
* ``make_fused_rounds`` runs R rounds as one block with the server's key
  schedule derived on the device and the eval cadence inside the block;
  on the card :meth:`BatchedRoundEngine.run_block` captures each block
  shape once as a CUDA graph and replays it (one launch from the host per
  block), on the CPU it runs the same block eagerly;
* ``pipeline_blocks`` keeps up to ``depth`` blocks in flight, so the host
  finishes block k while the card runs block k+1.

The mesh schedules are here too: :func:`make_sharded_fedx_round` and
:func:`make_sharded_fedavg_round` run one client per rank of a
``DeviceMesh`` axis, with real collectives between processes
(:class:`MeshRound`; wrapped by ``repro_torch.core.distributed``).
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import random, spans as spanlog, tree
from repro_torch.analysis.walker import loss_uses_conv
from repro_torch.convert import ravel_params
from repro_torch.core.client import (ClientHP, Task, make_client_update,
                                     make_update)
from repro_torch.core.knobs import parse_vectorize
from repro_torch.kernels.bwo_evolve import bwo_evolve as bwo_kernel
from repro_torch.metaheuristics import Metaheuristic
from repro_torch.metaheuristics.base import take


def resolve_vectorize(mode: str, device) -> str:
    """Resolve the ``vectorize`` knob to a concrete client-axis strategy
    for ``device``.

    ``vmap``   — one batched program over the client axis
                 (``torch.func.vmap``): each op is issued once for all
                 clients.  The card's mode: the round is bound by the
                 host issuing small ops.
    ``scan``   — a Python loop over clients with the streaming winner
                 reduction (O(2 x model) weights).  A ``"scan:k"`` chunk
                 (the reference's ``lax.scan`` unroll) means nothing to a
                 Python loop: it runs the same loop.
    ``unroll`` — the same loop (the reference unrolls its scan in XLA).
    ``auto``   — ``scan`` on the CPU, ``vmap`` on CUDA.  The port decides
                 by the device the round runs on, where the reference
                 asks the global backend.
    """
    base, _ = parse_vectorize(mode)
    if base != "auto":
        return base
    return "scan" if torch.device(device).type == "cpu" else "vmap"


def task_uses_conv(task: Task, params, sample_batch) -> bool:
    """Run ``task.loss_fn`` once on one batch and report whether it
    reached a convolution.  Drives the CPU engine="auto" decision, as in
    the reference: convolutions of vmapped weights become grouped
    convolutions, which are slow on the CPU, so conv tasks stay on the
    sequential engine there.  The reference walks a jaxpr through its
    walker; the port records the ops the call dispatches through its own
    (:func:`repro_torch.analysis.walker.loss_uses_conv`).  Returns True
    (the conservative answer) when the call raises."""
    return loss_uses_conv(task.loss_fn, params, sample_batch)


def stack_clients(client_data: Sequence[Any], pad: bool = False):
    """Stack per-client trees along a new leading client axis.

    With ``pad=False``: returns the stacked tree, or ``None`` when the
    clients are not exactly stackable (ragged batch counts or mismatched
    structures).

    With ``pad=True``: returns ``(stacked, mask)``.  Ragged *leading*
    (batch-count) axes — e.g. a Dirichlet split — are zero-padded to the
    longest client, and ``mask`` is a ``(n_clients, max_batches)`` bool
    tensor marking the valid rows (all True when the clients were
    already uniform).  A client with no batches gets an all-False row;
    callers that cannot train an empty client detect it and raise.
    ``(None, None)`` when the clients are genuinely unstackable:
    mismatched tree structures, trailing batch shapes, dtypes or devices,
    or inconsistent leading dims within one client.
    """
    empty = (None, None) if pad else None
    if not client_data:
        return empty
    ref = tree.structure(client_data[0])
    ref_leaves = tree.leaves(client_data[0])
    lens = []
    for d in client_data:
        if tree.structure(d) != ref:
            return empty
        leaves = tree.leaves(d)
        heads = {l.shape[0] if l.dim() else None for l in leaves}
        if len(heads) != 1 or None in heads:
            return empty
        lens.append(heads.pop())
        if any(a.shape[1:] != b.shape[1:] or a.dtype != b.dtype
               or a.device != b.device for a, b in zip(leaves, ref_leaves)):
            return empty
    if not pad:
        if len(set(lens)) > 1:
            return None
        return tree.map(lambda *xs: torch.stack(xs), *client_data)
    max_len = max(lens)

    def pad_to(a):
        if a.shape[0] == max_len:
            return a
        fill = a.new_zeros((max_len - a.shape[0], *a.shape[1:]))
        return torch.cat([a, fill])

    stacked = tree.map(lambda *xs: torch.stack([pad_to(x) for x in xs]),
                       *client_data)
    device = ref_leaves[0].device
    mask = (torch.arange(max_len, device=device)[None, :]
            < torch.tensor(lens, device=device)[:, None])
    return stacked, mask


def _tree_where(pred, a, b):
    return tree.map(lambda x, y: torch.where(pred, x, y), a, b)


def _vmap_clients(update, global_params, data, mask, keys):
    """``update`` once for all clients: vmapped over the client axis of
    data, mask (when the data are padded) and keys.  The spans opened
    inside are one for all clients: their per-client counts are
    multiplied by the client count."""
    in_dims = (None, 0, None if mask is None else 0, 0)
    with spanlog.batched(keys.shape[0]):
        return torch.func.vmap(update, in_dims=in_dims)(global_params, data,
                                                        mask, keys)


def _row(data, mask, keys, k):
    return (tree.map(lambda a: a[k], data),
            None if mask is None else mask[k], keys[k])


# ------------------------------------------------------------ batched --
def make_batched_fedx_round(task: Task, hp: ClientHP, mh: Metaheuristic,
                            device, vectorize: str = "auto"):
    """Returns ``round_fn(global_params, data, mask, keys) ->
    (best_params, scores, best_idx)``, all on the device.

    ``data``: client datasets stacked to ``(n_clients, ...)`` leaves.
    ``mask``: ``(n_clients, n_batches)`` bool validity rows from
    ``stack_clients(..., pad=True)``, or None for uniform data.
    ``keys``: ``(n_clients, 2)`` keys, one a client.
    """
    mode = resolve_vectorize(vectorize, device)
    update = make_update(task, hp, mh)

    if mode == "vmap":
        def round_fn(global_params, data, mask, keys):
            scores, new = _vmap_clients(update, global_params, data, mask,
                                        keys)
            best = torch.argmin(scores)
            return tree.map(lambda a: take(a, best), new), scores, best
        return round_fn

    def round_fn(global_params, data, mask, keys):
        best_fit = torch.full((), float("inf"), device=keys.device)
        winner, scores = global_params, []
        for k in range(keys.shape[0]):
            score, params = update(global_params, *_row(data, mask, keys, k))
            # streaming winner reduction: one model held beside the new one
            winner = _tree_where(score < best_fit, params, winner)
            best_fit = torch.minimum(score, best_fit)
            scores.append(score)
        scores = torch.stack(scores)
        return winner, scores, torch.argmin(scores)

    return round_fn


def make_batched_fedavg_round(task: Task, hp: ClientHP, device,
                              vectorize: str = "auto"):
    """Returns ``round_fn(global_params, data, mask, keys) ->
    (avg_params, scores)`` over the (already gathered) participant axis.
    See :func:`make_batched_fedx_round`."""
    mode = resolve_vectorize(vectorize, device)
    update = make_update(task, hp)

    if mode == "vmap":
        def round_fn(global_params, data, mask, keys):
            scores, new = _vmap_clients(update, global_params, data, mask,
                                        keys)
            return tree.map(lambda a: a.mean(0), new), scores
        return round_fn

    def round_fn(global_params, data, mask, keys):
        m = keys.shape[0]
        acc = tree.map(torch.zeros_like, global_params)
        scores = []
        for k in range(m):
            score, params = update(global_params, *_row(data, mask, keys, k))
            # running mean: one accumulator beside the new model
            acc = tree.map(lambda s, p: s + p / m, acc, params)
            scores.append(score)
        return acc, torch.stack(scores)

    return round_fn


def _fedavg_participants(round_fn, global_params, data, mask, sel_key, keys,
                         n_clients: int, m: int):
    """Sample-then-stack: the ``m`` participants drawn on the device with
    the reference's ``choice``, their shards, mask rows and keys gathered,
    and the round run over them only.  -> (avg_params, scores, sel)."""
    sel = random.choice(sel_key, n_clients, (m,))
    sub = tree.map(lambda a: a[sel], data)
    msk = None if mask is None else mask[sel]
    avg, scores = round_fn(global_params, sub, msk, keys[sel])
    return avg, scores, sel


# -------------------------------------------------------------- fused --
def eval_due(n_rounds: int, eval_every: int, round_offset: int) -> tuple:
    """Which rounds of a block starting after ``round_offset`` rounds
    evaluate: round ``round_offset + i`` when ``(round_offset + i + 1) %
    eval_every == 0``, and always the block's last round; none when
    ``eval_every`` is 0."""
    if eval_every <= 0:
        return (False,) * n_rounds
    return tuple((round_offset + i + 1) % eval_every == 0 or i == n_rounds - 1
                 for i in range(n_rounds))


def make_fused_rounds(task: Task, strategy, hp: ClientHP,
                      rounds_per_dispatch: int, *, n_clients: int, device,
                      vectorize: str = "auto", eval_every: int = 0,
                      spans: bool = True):
    """Fuse ``rounds_per_dispatch`` FL rounds into one block.

    Returns ``block_fn(global_params, rng, data, mask, eval_batch,
    round_offset) -> (params, rng, logs)``, where ``logs`` holds stacked
    per-round device tensors:

    * FedX:   ``{"scores": (R, n), "best": (R,)}``
    * FedAvg: ``{"scores": (R, m), "participants": (R, m)}``
    * plus ``{"eval_loss": (R,), "eval_acc": (R,)}`` when ``eval_every >
      0`` and an ``eval_batch`` is passed: ``task.loss_fn`` on the
      held-out batch on the rounds :func:`eval_due` names, NaN on the
      others;
    * plus ``{"spans": (2 x stamps,) int32}`` with ``spans`` on: the
      block's device span stamps (:mod:`repro_torch.spans`), one
      ``round`` span a round around its key split, client update, server
      step and evaluation, the ``sgd``, ``fitness`` and ``threefry`` spans
      inside.  ``block_fn.span_schema`` holds the schema of its last call
      (None with ``spans`` off, which stamps nothing).

    Each round derives its keys on the device exactly as
    ``Server.run_round`` does, ``random.split(rng, n_clients + 2) ->
    (rng, sel_key, client_keys)``, and runs the single-round engine's
    round function (:func:`make_batched_fedx_round` /
    :func:`make_batched_fedavg_round`), so a block is bit-identical to R
    ``run_round`` calls.  FedAvg at ``client_ratio < 1`` draws its
    participants on the device and gathers inside the block.

    Nothing in a block reads a tensor on the host, so the card can
    capture it as one CUDA graph (:meth:`BatchedRoundEngine.run_block`).
    ``round_offset`` is a host integer: it fixes which rounds evaluate
    (the reference traces it; a graph fixes it per capture).
    """
    n_rounds = int(rounds_per_dispatch)
    if n_rounds < 1:
        raise ValueError(
            f"rounds_per_dispatch={rounds_per_dispatch!r} must be >= 1")
    is_fedx = getattr(strategy, "is_fedx", False)
    if is_fedx:
        round_fn = make_batched_fedx_round(task, hp, strategy.mh, device,
                                           vectorize=vectorize)
    else:
        round_fn = make_batched_fedavg_round(task, hp, device,
                                             vectorize=vectorize)
        m = max(int(strategy.client_ratio * n_clients), 1)

    def block_fn(global_params, rng, data, mask, eval_batch, round_offset):
        due = eval_due(n_rounds,
                       eval_every if eval_batch is not None else 0,
                       int(round_offset))  # flcheck: ok (a host int)
        recording = (spanlog.recording(rng.device) if spans
                     else contextlib.nullcontext())
        with recording as rec:
            params, logs = global_params, []
            for i in range(n_rounds):
                with spanlog.span("round", round=i):
                    # Server.run_round's key schedule, derived on the device
                    keys = random.split(rng, n_clients + 2)
                    rng, sel_key, ckeys = keys[0], keys[1], keys[2:]
                    if is_fedx:
                        params, scores, best = round_fn(params, data, mask,
                                                        ckeys)
                        log = {"scores": scores, "best": best}
                    else:
                        params, scores, sel = _fedavg_participants(
                            round_fn, params, data, mask, sel_key, ckeys,
                            n_clients, m)
                        log = {"scores": scores, "participants": sel}
                    if any(due):
                        if due[i]:
                            with torch.no_grad():
                                loss, acc = task.loss_fn(params, eval_batch)
                            loss, acc = loss.float(), acc.float()
                        else:
                            loss = acc = torch.full((), float("nan"),
                                                    device=rng.device)
                        log["eval_loss"], log["eval_acc"] = loss, acc
                logs.append(log)
            out = {k: torch.stack([log[k] for log in logs]) for k in logs[0]}
            if rec is not None:
                out["spans"], block_fn.span_schema = rec.finish()
        return params, rng, out

    block_fn.span_schema = None
    return block_fn


class CapturedBlock:
    """One fused block shape, captured once as a CUDA graph and replayed.

    The graph reads its inputs from static tensors (``params``, ``rng``,
    the eval batch) and writes its outputs into static tensors of its
    private memory pool, which it rewrites at every replay.  A call copies
    the caller's inputs into the static ones, replays, and returns copies
    of the outputs, all in stream order: block k's outputs are copied out
    before block k+1's replay is enqueued, and block k's params and rng
    flow into block k+1's inputs on the stream, with no host round trip.

    The capture records ``bwo_evolve``'s launches without running them;
    each replay runs them, and counts them (``launches`` a replay).  The
    capture is a ``capture`` host span (:func:`repro_torch.spans.host`,
    under ``owner``), which ``capture_s`` reads; ``span_schema`` is the
    block's device span schema, fixed by the capture (None without
    spans).

    With ``keep_graph`` the graph keeps its ``cudaGraph_t`` after
    instantiation, so that its nodes can be dumped
    (:func:`repro_torch.launch.graph_analysis.dump_graph`, flcheck's read
    of a block); the engine's own captures drop it.
    """

    def __init__(self, block_fn, params, rng, data, mask, eval_batch,
                 round_offset: int, stream, keep_graph: bool = False,
                 owner: Optional[int] = None):
        self.params = tree.map(torch.clone, params)
        self.rng = rng.clone()
        self.eval_batch = (None if eval_batch is None
                           else tree.map(torch.clone, eval_batch))
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        before = bwo_kernel.launches
        with spanlog.host("capture", owner) as self._capture:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = block_fn(self.params, self.rng, data, mask,
                                    self.eval_batch, round_offset)
            if keep_graph:
                self.graph.instantiate()
        self.span_schema = getattr(block_fn, "span_schema", None)
        self.launches = bwo_kernel.launches - before
        bwo_kernel.launches = before        # recorded, not yet run
        self.replays = 0

    @property
    def capture_s(self) -> float:
        """The capture's seconds, read from its ``capture`` host span."""
        return self._capture.seconds

    def __call__(self, params, rng, eval_batch):
        for dst, src in zip(tree.leaves(self.params), tree.leaves(params)):
            dst.copy_(src)
        self.rng.copy_(rng)
        if eval_batch is not None:
            for dst, src in zip(tree.leaves(self.eval_batch),
                                tree.leaves(eval_batch)):
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        bwo_kernel.launches += self.launches
        params, rng, logs = self.out
        return (tree.map(torch.clone, params), rng.clone(),
                {k: v.clone() for k, v in logs.items()})


class BatchedRoundEngine:
    """Whole-round executor used by :class:`repro_torch.core.Server`.

    Holds the stacked client data on the device and one round function
    per (task, strategy).  Ragged client datasets are padded to the
    longest client with a validity mask (``self.padded``); genuinely
    unstackable datasets (mismatched structures / trailing shapes /
    dtypes) raise ``ValueError`` at construction, and the server falls
    back to its sequential loop under engine="auto".

    FedAvg participation is sample-then-stack: ``fedavg_round`` samples
    the ``m = max(C * n, 1)`` participants, gathers their shards and runs
    the round over shape ``(m, ...)``.  The reference's
    ``traced_participant_counts`` counts jit traces; eager torch traces
    nothing, and what the card builds once and reuses is a block's CUDA
    graph, so its counterpart here is ``self.captures``: one entry per
    capture, in capture order, the block's shape (``rounds_per_dispatch``,
    ``eval_every`` and the rounds it evaluates), as the reference's entry
    is the participant count and not the whole signature.  An entry that
    appears twice is one block shape captured twice: the graph cache
    missed on a shape it holds, because the eval batch's shapes changed
    (flcheck's ``compile-cache-stability`` rule reads it).

    Fused blocks (:meth:`run_block`): one block function per
    ``(rounds_per_dispatch, eval_every)``, as the reference caches one
    executable per block shape.  On the card each block shape is captured
    once as a :class:`CapturedBlock` (``self.graphs``, keyed by the
    shape, the rounds it evaluates and the eval batch's shapes) after one
    eager warm-up round on the capture stream, the engine's first only
    (it loads the kernel library and sets up cuDNN's and cuBLAS's handles
    and workspaces for that stream); ``warmup_launches`` counts the
    ``bwo_evolve`` launches that warm-up ran.  A capture that fails
    raises: there is no eager fallback on the card.

    Spans (:mod:`repro_torch.spans`): the warm-up round and each capture
    are host spans under ``span_owner``; with ``spans`` on, each block
    stamps its device spans, and ``block_spans`` is the schema of the
    block that :meth:`run_block` ran last (None with ``spans`` off).
    """

    def __init__(self, task: Task, strategy, hp: ClientHP,
                 client_data: Sequence[Any], device, spans: bool = True):
        stacked, mask = stack_clients(client_data, pad=True)
        if stacked is None:
            raise ValueError(
                "client datasets are not stackable: tree structures, "
                "trailing batch shapes, and dtypes must match across "
                "clients (ragged batch counts alone are fine — they are "
                "padded and masked)")
        valid = mask.any(dim=1).cpu()
        if not bool(valid.all()):
            empty = torch.nonzero(~valid).flatten().tolist()
            raise ValueError(
                f"client shards {empty} are empty (0 batches): an "
                f"all-padded client has no data to train or score on — "
                f"extreme Dirichlet skew can starve clients; drop empty "
                f"shards or repartition before building the engine")
        self.n_clients = len(client_data)
        self.data = stacked
        self.padded = not bool(mask.all())
        self.mask = mask if self.padded else None
        self.is_fedx = strategy.is_fedx
        self.device = torch.device(device)
        self.vectorize = resolve_vectorize(hp.vectorize, device)
        self._task, self._strategy, self._hp = task, strategy, hp
        self._fused: Dict[tuple, Callable] = {}
        self.graphs: Dict[tuple, CapturedBlock] = {}
        self.captures: List[tuple] = []
        self.warmup_launches = 0
        self._capture_stream = None
        self.spans = bool(spans)
        self.span_owner = spanlog.new_owner()
        self.block_spans = None
        if self.is_fedx:
            self.n_participants = self.n_clients
            self._round = make_batched_fedx_round(
                task, hp, strategy.mh, device, vectorize=hp.vectorize)
        else:
            self.n_participants = max(
                int(strategy.client_ratio * self.n_clients), 1)
            self._round = make_batched_fedavg_round(
                task, hp, device, vectorize=hp.vectorize)

    def fused_rounds(self, rounds_per_dispatch: int, eval_every: int = 0):
        """The R-round block function (:func:`make_fused_rounds`) for this
        engine's task, strategy and data layout, cached per
        ``(rounds_per_dispatch, eval_every)``."""
        key = (int(rounds_per_dispatch), int(eval_every))
        fn = self._fused.get(key)
        if fn is None:
            fn = make_fused_rounds(
                self._task, self._strategy, self._hp, key[0],
                n_clients=self.n_clients, device=self.device,
                vectorize=self._hp.vectorize, eval_every=key[1],
                spans=self.spans)
            self._fused[key] = fn
        return fn

    def run_block(self, global_params, rng, rounds_per_dispatch: int,
                  eval_batch=None, eval_every: int = 0,
                  round_offset: int = 0):
        """Run one fused block: ``-> (params, rng, logs)`` with ``logs``
        the stacked per-round device tensors, the block's own copies (one
        device->host copy for the whole block when the caller fetches
        them).  On the card: one replay of the block's graph, captured at
        its first use; on the CPU: the block function, eagerly."""
        if eval_batch is None:
            eval_every = 0
        block = self.fused_rounds(rounds_per_dispatch, eval_every)
        if self.device.type != "cuda":
            out = block(global_params, rng, self.data, self.mask,
                        eval_batch, round_offset)
            self.block_spans = block.span_schema
            return out
        shape = (int(rounds_per_dispatch), int(eval_every),
                 eval_due(int(rounds_per_dispatch), int(eval_every),
                          int(round_offset)))
        key = shape + (tuple(tuple(l.shape) for l in tree.leaves(eval_batch))
                       if eval_batch is not None else None,)
        graph = self.graphs.get(key)
        if graph is None:
            stream = self._warm_up(global_params, rng, eval_batch,
                                   eval_every)
            graph = CapturedBlock(block, global_params, rng, self.data,
                                  self.mask, eval_batch, round_offset,
                                  stream, owner=self.span_owner)
            self.graphs[key] = graph
            self.captures.append(shape)
        self.block_spans = graph.span_schema
        return graph(global_params, rng, eval_batch)

    def _warm_up(self, global_params, rng, eval_batch, eval_every: int):
        """The capture stream, after one eager round on it (the first
        time only), its results dropped; the round and its sync are the
        ``warmup`` host span."""
        if self._capture_stream is not None:
            return self._capture_stream
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        before = bwo_kernel.launches
        with spanlog.host("warmup", self.span_owner):
            with torch.cuda.stream(stream):
                self.fused_rounds(1, eval_every)(global_params, rng,
                                                 self.data, self.mask,
                                                 eval_batch, 0)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
        self.warmup_launches += bwo_kernel.launches - before
        self._capture_stream = stream
        return stream

    def fedx_round(self, global_params, keys):
        """-> (winner_params, scores, best_idx), on the device."""
        return self._round(global_params, self.data, self.mask, keys)

    def fedavg_round(self, global_params, sel_key, keys):
        """-> (avg_params, scores, sel), on the device (sample-then-stack:
        the participants drawn on the device, the ``(m, ...)`` shards
        gathered, and the round run over them only)."""
        return _fedavg_participants(self._round, global_params, self.data,
                                    self.mask, sel_key, keys,
                                    self.n_clients, self.n_participants)


# ----------------------------------------------------------- pipeline --
def pipeline_blocks(dispatch: Callable[[Any], Any],
                    finish: Callable[[Any], Any],
                    schedule, depth: int = 2,
                    should_stop: Optional[Callable[[Any], bool]] = None):
    """Generic double-buffered dispatch/finish driver (the reference's,
    pure Python).

    Pulls block specs lazily from ``schedule``, keeps up to ``depth``
    dispatched blocks in flight, and finishes them in dispatch order:
    with ``depth=2`` block ``k+1`` is dispatched *before* block ``k`` is
    finished, so the host work inside ``finish`` (the device->host copy
    and log processing) overlaps block ``k+1``'s run on the card, where a
    dispatch only enqueues.

    ``should_stop(result)`` is consulted after each finish; once it
    returns True no further block is dispatched, but already-dispatched
    blocks are still finished (their side effects — device state, meter
    entries — have already happened), giving a worst-case overshoot of
    ``depth - 1`` blocks.  Returns ``(results, kept, stopped)`` where
    ``results`` covers every dispatched block in order and ``kept``
    counts the leading results up to and including the one that
    triggered the stop (``kept == len(results)`` when nothing did) —
    callers trim their logs to ``results[:kept]``.
    """
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    pending = deque()
    results: List[Any] = []
    it = iter(schedule)
    stopped = False
    kept: Optional[int] = None
    while True:
        while not stopped and len(pending) < depth:
            try:
                spec = next(it)
            except StopIteration:
                break
            pending.append(dispatch(spec))
        if not pending:
            break
        res = finish(pending.popleft())
        results.append(res)
        if not stopped and should_stop is not None and should_stop(res):
            stopped, kept = True, len(results)
    return results, len(results) if kept is None else kept, stopped


# ------------------------------------------------------------ sharded --
def _squeeze0(tree_, what: str):
    """A rank's shard without its leading dim of 1.  The reference's
    ``_squeeze0`` keeps element 0 of a longer shard and drops the rest;
    here a shard of more than one client raises."""
    def one(a):
        if a.dim() == 0 or a.shape[0] != 1:
            raise ValueError(
                f"each rank holds one client: {what} has shape "
                f"{tuple(a.shape)}, expected a leading dim of 1")
        return a[0]
    return tree.map(one, tree_)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MeshRound:
    """One FL round over the ranks of a mesh axis: every rank of the axis's
    group calls ``round_fn(global_params, client_data, keys)`` with its own
    shard (leaves with a leading dim of 1, keys of shape (1, 2)), as each
    shard of the reference's ``shard_map`` runs the round body.  Local
    training runs with no collective; the round's traffic is FedX's score
    all-gather and winner broadcast, or FedAvg's all-reduce.  Returns
    ``(new_global_params, scores)``, the same on every rank.

    The device is synchronised around each collective (the round reads the
    winner on the host anyway), so ``seconds`` holds each collective's own
    host time in the last call (the all-gather's includes waiting for the
    last rank to finish its update).  ``traffic`` holds the bytes each
    carried from the clients, read from the tensors passed: the all-gather
    n x 4, the broadcast the winner's M, the all-reduce every rank's M."""

    def __init__(self, update, group, fedx: bool):
        self.update = update
        self.group = group
        self.fedx = fedx
        self.n = dist.get_world_size(group)
        self.traffic: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def _collective(self, name: str, nbytes: int, device, call) -> None:
        _sync(device)
        t0 = time.perf_counter()
        call()
        _sync(device)
        self.seconds[name] = time.perf_counter() - t0
        self.traffic[name] = nbytes

    def __call__(self, global_params, client_data, keys):
        score, new_params = self.update(global_params,
                                        _squeeze0(client_data, "client data"),
                                        _squeeze0(keys, "keys"))
        dev = score.device
        score = score.reshape(1).to(torch.float32)
        gathered = [torch.empty_like(score) for _ in range(self.n)]
        self._collective(
            "all_gather", self.n * score.element_size(), dev,
            lambda: dist.all_gather(gathered, score, group=self.group))
        scores = torch.cat(gathered)
        leaves = tree.leaves(new_params)
        if self.fedx:
            # the first index on ties, as jnp.argmin; read on the host
            winner = int(torch.argmin(scores))
            flat, unravel = ravel_params(new_params)
            self._collective(
                "broadcast", flat.numel() * flat.element_size(), dev,
                lambda: dist.broadcast(
                    flat, src=dist.get_global_rank(self.group, winner),
                    group=self.group))
            out = [a.to(l.dtype) for a, l in zip(tree.leaves(unravel(flat)),
                                                  leaves)]
        else:
            flat = torch.cat([l.reshape(-1).to(torch.float32)
                              for l in leaves])
            self._collective(
                "all_reduce", self.n * flat.numel() * flat.element_size(),
                dev, lambda: dist.all_reduce(flat, group=self.group))
            flat /= self.n
            out = [p.reshape(l.shape).to(l.dtype) for p, l in zip(
                torch.split(flat, [l.numel() for l in leaves]), leaves)]
        return tree.unflatten(tree.structure(new_params), out), scores


def make_sharded_fedx_round(task: Task, hp: ClientHP, mh: Metaheuristic,
                            mesh, axis: str = "clients") -> MeshRound:
    """Mesh placement of the FedX round: clients map to the ranks of
    ``axis`` (a ``DeviceMesh`` dim), local training runs with zero
    collectives, and the cross-rank traffic is one float32 all-gather (N
    x 4 bytes) plus one broadcast of the winner's raveled weights from its
    rank (M bytes) — see repro_torch.core.distributed.  The winner is
    ``argmin(scores)``, read on the host once a round."""
    return MeshRound(make_client_update(task, hp, mh), mesh.get_group(axis),
                     fedx=True)


def make_sharded_fedavg_round(task: Task, hp: ClientHP, mesh,
                              axis: str = "clients") -> MeshRound:
    """Mesh placement of FedAvg: a full-model all-reduce every round (each
    leaf's float32 sum, in one buffer, over the group's size, cast back to
    the leaf's type), plus the score all-gather."""
    return MeshRound(make_client_update(task, hp, None), mesh.get_group(axis),
                     fedx=False)
