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
  way.

Not here yet: fused multi-round blocks and pipelined dispatch
(``make_fused_rounds``, ``pipeline_blocks``; ROADMAP.md, queue 1, item 9)
and the mesh schedules (``make_sharded_*``, item 10).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import random, tree
from repro_torch.core.client import ClientHP, Task, make_update
from repro_torch.core.knobs import parse_vectorize
from repro_torch.metaheuristics import Metaheuristic


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


class _ConvRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten._convolution):
            self.seen = True
        return func(*args, **(kwargs or {}))


def task_uses_conv(task: Task, params, sample_batch) -> bool:
    """Run ``task.loss_fn`` once on one batch and report whether it
    reached a convolution.  Drives the CPU engine="auto" decision, as in
    the reference: convolutions of vmapped weights become grouped
    convolutions, which are slow on the CPU, so conv tasks stay on the
    sequential engine there.  The reference walks a jaxpr; the port
    records the ``aten`` ops the call dispatches.  Returns True (the
    conservative answer) when the call raises."""
    try:
        with torch.no_grad(), _ConvRecorder() as rec:
            task.loss_fn(params, sample_batch)
    except Exception:
        return True
    return rec.seen


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
    data, mask (when the data are padded) and keys."""
    in_dims = (None, 0, None if mask is None else 0, 0)
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
            return tree.map(lambda a: a[best], new), scores, best
        return round_fn

    def round_fn(global_params, data, mask, keys):
        best_fit = torch.tensor(float("inf"), device=keys.device)
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
    nothing, so it has no counterpart here.
    """

    def __init__(self, task: Task, strategy, hp: ClientHP,
                 client_data: Sequence[Any], device):
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
        self.vectorize = resolve_vectorize(hp.vectorize, device)
        if self.is_fedx:
            self.n_participants = self.n_clients
            self._round = make_batched_fedx_round(
                task, hp, strategy.mh, device, vectorize=hp.vectorize)
        else:
            self.n_participants = max(
                int(strategy.client_ratio * self.n_clients), 1)
            self._round = make_batched_fedavg_round(
                task, hp, device, vectorize=hp.vectorize)

    def fedx_round(self, global_params, keys):
        """-> (winner_params, scores, best_idx), on the device."""
        return self._round(global_params, self.data, self.mask, keys)

    def fedavg_round(self, global_params, sel_key, keys):
        """-> (avg_params, scores, sel), on the device.

        Sample-then-stack: the participants are drawn on the device, the
        ``(m, ...)`` shards gathered, and the round runs over them only.
        """
        sel = random.choice(sel_key, self.n_clients, (self.n_participants,))
        sub = tree.map(lambda a: a[sel], self.data)
        mask = None if self.mask is None else self.mask[sel]
        avg, scores = self._round(global_params, sub, mask, keys[sel])
        return avg, scores, sel
