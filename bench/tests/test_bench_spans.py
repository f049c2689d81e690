"""The span metrics' readers on a hand-made span log: each reads the right
number from the latest engine's traced rounds, and None without its
spans or without the port's span log."""
import sys
import types
from collections import deque

import pytest

from bench import cell, counts, spans as bench_spans
from repro_torch import spans

TRAFFIC = {"strategy": "fedbwo", "n_clients": 2, "client_ratio": 1.0,
           "n_train": 40, "batch_size": 10, "local_epochs": 2, "mh_pop": 3,
           "mh_generations": 1, "fitness_batches": 2,
           "rounds_per_dispatch": 2, "eval_every": 1, "n_test": 10}
CFG = {"model": "mlp", "image_size": 4, "channels": 1, "hidden": 8,
       "num_classes": 10}
MS = 1_000_000


def S(name, begin, end, parent=None, round=None, count=None):
    return spans.Span(name, begin * MS, end * MS, parent, round, count)


def round_spans(r, t):
    """One round from ``t`` ms: 100 ms long, an sgd span of 40 ms with a
    10 ms draw inside, a 20 ms draw of 5e6 words, a 25 ms fitness."""
    return [S("round", t, t + 100, None, r),
            S("sgd", t + 1, t + 41, 0, r, 80),
            S("threefry", t + 5, t + 15, 1, r, 1_000_000),
            S("threefry", t + 45, t + 65, 0, r, 5_000_000),
            S("fitness", t + 70, t + 95, 0, r, 120)]


def reindex(parts):
    """Concatenated rounds with their parents shifted to the block's list."""
    out = []
    for part in parts:
        base = len(out)
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + base) for s in part]
    return tuple(out)


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spans, "BLOCKS", deque(maxlen=spans.BLOCKS_KEPT))
    monkeypatch.setattr(spans, "SETUP", deque(maxlen=spans.BLOCKS_KEPT))
    # an earlier engine's block and set-up, which no reader may take
    spans.BLOCKS.append(spans.Block(1, 4, reindex([round_spans(4, 0)])))
    spans.SETUP.append((1, S("warmup", 0, 9000)))
    spans.SETUP.append((2, S("warmup", 0, 2500)))
    spans.SETUP.append((None, S("capture", 0, 7000)))     # an audit's
    spans.SETUP.append((2, S("capture", 3000, 4000)))
    spans.SETUP.append((2, S("capture", 5000, 5500)))
    for offset in (0, 2, 4):
        spans.BLOCKS.append(spans.Block(2, offset, reindex(
            [round_spans(offset + i, 1000 * (offset + i)) for i in range(2)])))
    return spans


def ctx(traced_from=2, rounds=4, traced=True):
    trace = types.SimpleNamespace(rounds=rounds) if traced else None
    return cell.Context(CFG, TRAFFIC, trace, traced_from, {}, {})


def test_the_helper_sums_the_latest_engines_traced_rounds(log):
    s = bench_spans.traced(ctx())
    assert s["round"] == {"s": pytest.approx(0.4), "self_s": pytest.approx(
        0.4 - 4 * 0.085), "count": 0, "n": 4}
    assert s["sgd"]["s"] == pytest.approx(0.16)
    assert s["sgd"]["self_s"] == pytest.approx(0.12)
    assert s["threefry"]["count"] == 4 * 6_000_000
    assert bench_spans.traced(ctx(traced_from=100)) is None
    assert bench_spans.traced(ctx(traced=False)) is None


@pytest.mark.parametrize("name, want", [
    ("threefry_share", 100.0 * 0.12 / 0.4),
    ("threefry_gwords_per_s", 24e6 / 0.12 / 1e9),
    ("client_sgd_mfu", None),
    ("fitness_mfu", None),
    ("warmup_round_s", 2.5),
    ("graph_capture_s", 1.5)])
def test_each_reader_reads_its_number(log, name, want):
    if name == "client_sgd_mfu":
        flops = 3 * counts.round_samples(TRAFFIC)["trained"] * \
            counts.forward_flops(CFG) * 4
        want = 100.0 * flops / (4 * 0.03 * counts.PEAKS["float32_flop_per_s"])
    if name == "fitness_mfu":
        flops = counts.round_samples(TRAFFIC)["fitness"] * \
            counts.forward_flops(CFG) * 4
        want = 100.0 * flops / (4 * 0.025 * counts.PEAKS["float32_flop_per_s"])
    assert cell.read_metric(name, ctx()) == pytest.approx(want)


NAMES = ["threefry_share", "threefry_gwords_per_s", "client_sgd_mfu",
         "fitness_mfu", "warmup_round_s", "graph_capture_s"]


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_gives_none_without_its_spans(monkeypatch, name):
    monkeypatch.setattr(spans, "BLOCKS", deque(maxlen=spans.BLOCKS_KEPT))
    monkeypatch.setattr(spans, "SETUP", deque(maxlen=spans.BLOCKS_KEPT))
    # a log holding only another kind of span
    spans.BLOCKS.append(spans.Block(3, 2, (S("round", 0, 5, None, 2),)))
    spans.SETUP.append((3, S("elsewhere", 0, 5)))
    assert cell.read_metric(name, ctx()) is None
    # a port without the span log (the parent of this change)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert cell.read_metric(name, ctx()) is None
