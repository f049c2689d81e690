"""threefry_kernel_share on a hand-made span log: the share of the traced
rounds' drawn counters that ``threefry_kernel`` spans hashed, and None on
a log without them (a port whose draws take no kernel)."""
import sys
from collections import deque

import pytest

from bench import cell
from bench.tests.test_bench_spans import S, ctx, reindex
from repro_torch import spans


def round_spans(r, t, kernel=True):
    """One 100 ms round: a draw of 1e6 counters inside sgd and one of 5e6
    in the round, each with a kernel span inside when ``kernel``."""
    out = [S("round", t, t + 100, None, r),
           S("sgd", t + 1, t + 41, 0, r, 80),
           S("threefry", t + 5, t + 15, 1, r, 1_000_000),
           S("threefry", t + 45, t + 65, 0, r, 5_000_000)]
    if kernel:
        out += [S("threefry_kernel", t + 6, t + 7, 2, r, 1_000_000),
                S("threefry_kernel", t + 46, t + 47, 3, r, 5_000_000)]
    return out


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spans, "BLOCKS", deque(maxlen=spans.BLOCKS_KEPT))
    monkeypatch.setattr(spans, "SETUP", deque(maxlen=spans.BLOCKS_KEPT))
    return spans


@pytest.mark.parametrize("kernel_rounds, want", [
    ((0, 1, 2, 3, 4, 5), 100.0),
    ((2, 3), 100.0 * 2 / 4),          # traced rounds 2..5: two of four
    ((4,), 100.0 * 1 / 4)])
def test_the_share_of_drawn_counters_the_kernel_hashed(log, kernel_rounds,
                                                       want):
    for offset in (0, 2, 4):
        log.BLOCKS.append(spans.Block(2, offset, reindex(
            [round_spans(r, 1000 * r, r in kernel_rounds)
             for r in (offset, offset + 1)])))
    assert cell.read_metric("threefry_kernel_share", ctx()) == \
        pytest.approx(want)


def test_none_without_kernel_spans_or_without_the_span_log(log,
                                                           monkeypatch):
    log.BLOCKS.append(spans.Block(2, 2, reindex(
        [round_spans(r, 1000 * r, False) for r in (2, 3)])))
    assert cell.read_metric("threefry_kernel_share", ctx()) is None
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert cell.read_metric("threefry_kernel_share", ctx()) is None
