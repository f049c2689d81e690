# A copy of repro/core/comm.py (pure Python), kept here so the port imports
# nothing of the JAX package; BlockTiming's docstring is the port's own.
"""Communication-cost accounting (paper §IV-D, Eqs. 1-4).

FedAvg uplink per round:  C * N * M          (Eq. 1 over T rounds)
FedX   uplink per round:  N * 4 + M + eps    (Eq. 2; eps = server request,
                                              0 on TPU program order)
Normalized FedX cost (C=1, fixed N=10):  T_X / (T_Avg * 10)   (Eq. 4)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

SCORE_BYTES = 4  # one fp32 performance score — the paper's headline number

# per-round strategy kinds recorded on the CommMeter ledger
KIND_FEDX = "fedx"
KIND_FEDAVG = "fedavg"


def fedavg_round_bytes(c: float, n_clients: int, model_bytes: int) -> int:
    return int(max(c * n_clients, 1)) * model_bytes


def fedx_round_bytes(n_clients: int, model_bytes: int, eps: int = 0) -> int:
    return n_clients * SCORE_BYTES + model_bytes + eps


def fedavg_total(t_rounds: int, c: float, n: int, m: int) -> int:
    return t_rounds * fedavg_round_bytes(c, n, m)                 # Eq. 1


def fedx_total(t_rounds: int, n: int, m: int, eps: int = 0) -> int:
    return t_rounds * fedx_round_bytes(n, m, eps)                 # Eq. 2


def normalized_cost(t_x, n: int = None, m: int = None, t_avg: int = 30,
                    c: float = 1.0, eps: int = 0) -> float:
    """Eq. 3; with the paper's simplification it reduces to Eq. 4.

    The first argument is either the FedX round count ``t_x`` (with
    ``n`` clients and ``m`` model bytes given explicitly) or a
    :class:`CommMeter`, from which ``t_x`` (recorded rounds), ``n``, and
    ``m`` are read — so callers stop re-deriving the Eq. 4 inputs by
    hand.  ``t_avg`` defaults to the paper's 30 FedAvg rounds.

    Eq. 4's numerator counts *FedX* rounds, so a meter that recorded any
    FedAvg rounds (its per-round ``kinds`` ledger says which) raises
    ``ValueError`` instead of silently pricing FedAvg uplink at FedX
    rates: compute the FedAvg side of the comparison from
    :func:`fedavg_total` (or ``meter.total_uplink``) instead.
    """
    if isinstance(t_x, CommMeter):
        meter = t_x
        non_fedx = [k for k in meter.kinds if k != KIND_FEDX]
        if non_fedx:
            counts = {k: meter.kinds.count(k) for k in set(meter.kinds)}
            raise ValueError(
                f"normalized_cost(meter): Eq. 4's t_x counts FedX rounds "
                f"only, but this meter recorded {counts} — price the "
                f"FedAvg rounds with fedavg_total/meter.total_uplink "
                f"instead of Eq. 4")
        t_x, n, m = len(meter.uplink), meter.n_clients, meter.model_bytes
    if n is None or m is None:
        raise TypeError("normalized_cost needs (t_x, n, m) explicitly "
                        "or a CommMeter as the first argument")
    return fedx_total(t_x, n, m, eps) / max(1, fedavg_total(t_avg, c, n, m))


@dataclasses.dataclass(frozen=True)
class BlockTiming:
    """Host-side timing of one fused block (DESIGN.md §7).

    ``dispatch_s`` is the time spent *enqueueing* the block: on the card
    the first block holds the engine's eager warm-up round and the
    capture of the block's CUDA graph (the ``warmup`` and ``capture``
    host spans of ``repro_torch.spans``), and every later block of that
    shape only a graph replay and the copies around it.  ``sync_s`` is
    the time the host waited for the block's logs: their one
    device->host copy, made on the server's fetch stream once the block
    has run.  ``process_s`` is the host-side info-dict reconstruction,
    meter bookkeeping and span decoding, and ``total_s`` the
    dispatch->finish wall time.  Under the double-buffered pipeline the
    next block executes while this block's logs are processed, so
    steady-state ``sync_s`` absorbs the device time the host could not
    hide — the overlap is observable as ``sync_s`` shrinking relative to
    the serial loop's.
    """
    n_rounds: int
    dispatch_s: float
    sync_s: float
    process_s: float
    total_s: float


@dataclasses.dataclass
class CommMeter:
    """Per-round byte accounting for a running FL experiment.

    ``kinds`` records each round's protocol (``"fedx"`` / ``"fedavg"``)
    so cost formulas that are strategy-specific (Eq. 4) can verify what
    they are pricing; ``block_timings`` is the per-block wall/sync
    ledger filled by ``record_block_timing`` (kept out of ``summary()``
    so byte ledgers of protocol-identical runs stay comparable).
    """
    model_bytes: int
    n_clients: int
    uplink: List[int] = dataclasses.field(default_factory=list)
    downlink: List[int] = dataclasses.field(default_factory=list)
    kinds: List[str] = dataclasses.field(default_factory=list)
    block_timings: List[BlockTiming] = dataclasses.field(
        default_factory=list)

    def record_fedavg_round(self, n_participants: int):
        self.uplink.append(n_participants * self.model_bytes)
        self.downlink.append(n_participants * self.model_bytes)
        self.kinds.append(KIND_FEDAVG)

    def record_fedx_round(self, fetched_model: bool = True):
        up = self.n_clients * SCORE_BYTES
        if fetched_model:
            up += self.model_bytes
        self.uplink.append(up)
        self.downlink.append(self.n_clients * self.model_bytes)
        self.kinds.append(KIND_FEDX)

    def record_block_timing(self, timing: BlockTiming):
        self.block_timings.append(timing)

    def timing_summary(self) -> Dict[str, float]:
        """Aggregate the block ledger: total/sync/process host seconds
        plus the per-round amortized wall time."""
        rounds = sum(t.n_rounds for t in self.block_timings)
        total = sum(t.total_s for t in self.block_timings)
        sync = sum(t.sync_s for t in self.block_timings)
        return {"blocks": len(self.block_timings),
                "rounds": rounds,
                "total_s": total,
                "dispatch_s": sum(t.dispatch_s for t in self.block_timings),
                "sync_s": sync,
                "process_s": sum(t.process_s for t in self.block_timings),
                "sync_fraction": sync / total if total else 0.0,
                "round_s": total / rounds if rounds else 0.0}

    def record_rounds(self, strategy, n_rounds: int,
                      n_participants: int = None,
                      fetched_model: bool = True):
        """Block recording for ``n_rounds`` protocol-identical rounds —
        the fused multi-round engine executes a whole block in one
        dispatch, then reconstructs the per-round ledger here so the
        byte accounting is entry-for-entry identical to ``n_rounds``
        single-round recordings.

        ``strategy`` is either a strategy name (``"fedavg"`` means
        FedAvg; any other name, e.g. ``"fedbwo"``, means FedX) or an
        object with an ``is_fedx`` attribute (e.g.
        ``repro.core.Strategy``).  FedAvg recording requires
        ``n_participants`` (fixed per round at a given client ratio).
        """
        is_fedx = getattr(strategy, "is_fedx", None)
        if is_fedx is None:
            is_fedx = str(strategy).lower() != "fedavg"
        if not is_fedx and n_participants is None:
            raise TypeError(
                "record_rounds for FedAvg needs n_participants")
        for _ in range(int(n_rounds)):
            if is_fedx:
                self.record_fedx_round(fetched_model=fetched_model)
            else:
                self.record_fedavg_round(n_participants)

    @property
    def total_uplink(self) -> int:
        return sum(self.uplink)

    @property
    def total_downlink(self) -> int:
        return sum(self.downlink)

    @property
    def total(self) -> int:
        return sum(self.uplink) + sum(self.downlink)

    def summary(self) -> Dict[str, float]:
        return {"rounds": len(self.uplink),
                "uplink_bytes": self.total_uplink,
                "downlink_bytes": self.total_downlink,
                "total_bytes": self.total,
                "model_bytes": self.model_bytes,
                "rounds_detail": [
                    {"round": i, "uplink_bytes": u, "downlink_bytes": d}
                    for i, (u, d) in enumerate(zip(self.uplink,
                                                   self.downlink))]}
