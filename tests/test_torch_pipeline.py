"""The double-buffered block pipeline in the port against the reference,
on the CPU.

``pipeline_blocks`` of both packages on the same fake dispatch, finish and
schedule, with a stop at each position and at each depth: equal
``results``, ``kept`` and ``stopped`` and the same order of dispatches and
finishes.  ``Server.run_pipelined`` and ``run_federated`` (fused and
pipelined) of both packages on the toy task: the same infos, ``kept``,
stop round and overshoot trimming.  Within the port, the pipelined run is
bit-exact with a serial ``run_block`` loop, as the reference's own
``tests/test_pipeline.py`` requires.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core.engine import pipeline_blocks as jpipeline_blocks  # noqa: E402
from repro.core.protocol import (StopConditions as JStop,  # noqa: E402
                                 run_federated as jrun_federated)
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.core.client import ClientHP  # noqa: E402
from repro_torch.core.engine import pipeline_blocks  # noqa: E402
from repro_torch.core.knobs import DEFAULT_PIPELINE_DEPTH  # noqa: E402
from repro_torch.core.protocol import StopConditions, run_federated  # noqa: E402
from repro_torch.core.server import Server, get_strategy  # noqa: E402

from conftest import make_toy_task  # noqa: E402
from test_torch_engine import HP, iid_clients, to_torch, torch_toy_task  # noqa: E402
from test_torch_fused_rounds import (BLOCK, EVERY, assert_infos_close,  # noqa: E402
                                     assert_params_close, toy_pair)


def drive(fn, depth, stop_at, n=5):
    """``fn`` (either package's pipeline_blocks) on a fake schedule of n
    blocks, recording each dispatch and finish."""
    events = []

    def dispatch(spec):
        events.append(("d", spec))
        return spec

    def finish(pending):
        events.append(("f", pending))
        return pending * 10

    out = fn(dispatch, finish, iter(range(1, n + 1)), depth=depth,
             should_stop=None if stop_at is None
             else (lambda r: r == stop_at * 10))
    return out, events


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("stop_at", [None, 1, 2, 3, 4, 5])
def test_pipeline_blocks_matches_reference(depth, stop_at):
    (results, kept, stopped), events = drive(pipeline_blocks, depth, stop_at)
    (jresults, jkept, jstopped), jevents = drive(jpipeline_blocks, depth,
                                                 stop_at)
    assert (results, kept, stopped) == (jresults, jkept, jstopped)
    assert events == jevents
    if stop_at is None:
        assert kept == len(results) == 5 and not stopped
    else:
        # the depth - 1 blocks in flight at the stop still finish
        assert stopped and kept == stop_at
        assert len(results) == min(5, stop_at + depth - 1)


def test_pipeline_blocks_depth_one_is_serial_and_zero_raises():
    _, events = drive(pipeline_blocks, 1, None, n=2)
    assert events == [("d", 1), ("f", 1), ("d", 2), ("f", 2)]
    _, events = drive(pipeline_blocks, 2, None, n=3)
    assert events == [("d", 1), ("d", 2), ("f", 1), ("d", 3), ("f", 2),
                      ("f", 3)]
    with pytest.raises(ValueError):
        pipeline_blocks(lambda s: s, lambda p: p, [1], depth=0)
    assert DEFAULT_PIPELINE_DEPTH == 2


# ---------------------------------------------------------- servers --
@pytest.mark.parametrize("case,split", [("fedbwo", "iid"),
                                        ("fedavg-partial", "iid"),
                                        ("fedbwo-kernel", "dirichlet")])
def test_run_pipelined_matches_reference(case, split):
    jserver, tserver, jeval, teval = toy_pair(case, "vmap", split)
    assert tserver.pipeline_blocks is jserver.pipeline_blocks is True
    want = jserver.run_pipelined(2 * BLOCK, eval_data=jeval,
                                 eval_every=EVERY)
    got = tserver.run_pipelined(2 * BLOCK, eval_data=teval,
                                eval_every=EVERY)
    assert (got.kept, got.stopped) == (want.kept, want.stopped) == \
        (2 * BLOCK, False)
    assert_infos_close(got.infos, want.infos)
    assert_params_close(tserver, jserver)
    assert tserver.meter.summary() == jserver.meter.summary()
    assert len(tserver.meter.block_timings) == 2


def test_run_pipelined_stop_overshoot_matches_reference():
    """A stop in block 1 finishes the block in flight (the server's state
    and meter advance) and ``kept`` trims the infos at block 1, in both
    packages."""
    jserver, tserver, jeval, teval = toy_pair("fedbwo", "scan", "iid")
    want = jserver.run_pipelined(4 * BLOCK, eval_data=jeval, eval_every=1,
                                 stop_fn=lambda info: True)
    got = tserver.run_pipelined(4 * BLOCK, eval_data=teval, eval_every=1,
                                stop_fn=lambda info: True)
    assert (got.kept, got.stopped, len(got.infos)) == \
        (want.kept, want.stopped, len(want.infos)) == (BLOCK, True,
                                                       2 * BLOCK)
    assert_infos_close(got.infos, want.infos)
    assert tserver.rounds_completed == jserver.rounds_completed == 2 * BLOCK
    assert len(tserver.meter.uplink) == len(jserver.meter.uplink) == 2 * BLOCK


def test_run_pipelined_bitexact_vs_serial_run_block():
    """Pipelining reorders host work, not device work: params, rng, infos
    and the byte ledger equal a serial run_block loop's, bit for bit."""
    _, serial, _, teval = toy_pair("fedbwo", "vmap", "dirichlet")
    _, piped, _, _ = toy_pair("fedbwo", "vmap", "dirichlet")
    infos = []
    for _ in range(3):
        infos += serial.run_block(BLOCK, eval_data=teval, eval_every=EVERY)
    res = piped.run_pipelined(3 * BLOCK, eval_data=teval, eval_every=EVERY)
    assert res.kept == 3 * BLOCK and not res.stopped
    for a, b in zip(tree.leaves(serial.global_params),
                    tree.leaves(piped.global_params)):
        assert torch.equal(a, b)
    assert torch.equal(serial.rng, piped.rng)
    assert len(infos) == len(res.infos)
    for a, b in zip(infos, res.infos):
        assert a.keys() == b.keys()
        assert all(a[k] == b[k] for k in a)
    assert serial.meter.summary() == piped.meter.summary()
    assert serial.meter.kinds == piped.meter.kinds
    timing = piped.meter.timing_summary()
    assert timing["blocks"] == 3 and timing["rounds"] == 3 * BLOCK
    assert 0.0 <= timing["sync_fraction"] <= 1.0
    assert "block_timings" not in piped.meter.summary()


def test_run_pipelined_sequential_fallback_no_overshoot():
    """On the sequential engine a forced pipeline is a serial run_block
    loop: a stop ends it at once, with no block in flight."""
    seq = Server(torch_toy_task(make_toy_task(), "y"),
                 get_strategy("fedbwo"), ClientHP(**HP),
                 to_torch(iid_clients()), R.PRNGKey(3, "cpu"),
                 engine="sequential", pipeline_blocks="on")
    assert seq.pipeline_blocks is True and seq.engine == "sequential"
    res = seq.run_pipelined(6, block_rounds=3, stop_fn=lambda info: True)
    assert res.stopped and res.kept == len(res.infos) == 3
    assert seq.rounds_completed == 3


# ---------------------------------------------------- run_federated --
@pytest.mark.parametrize("pipeline,tau,want_rounds", [
    (False, 1.1, 7), (True, 1.1, 7), (False, 0.0, BLOCK),
    (True, 0.0, BLOCK)])
def test_run_federated_matches_reference(pipeline, tau, want_rounds):
    """Fused (serial) and pipelined drivers of both packages, 7 rounds at
    R = 3: two blocks and one leftover single round when tau is never
    reached; at tau = 0 the stop in block 1 ends the logs there (the
    pipelined driver's in-flight block ran, and is trimmed)."""
    jserver, tserver, jeval, teval = toy_pair("fedbwo", "vmap", "iid")
    jserver.pipeline_blocks = tserver.pipeline_blocks = pipeline
    want = jrun_federated(jserver, jeval, JStop(max_rounds=7, patience=100,
                                                tau=tau))
    got = run_federated(tserver, teval, StopConditions(
        max_rounds=7, patience=100, tau=tau))
    assert len(got) == len(want) == want_rounds
    for g, w in zip(got, want):
        assert g.round == w.round
        assert g.info["engine"] == w.info["engine"]
        assert g.info["best_client"] == w.info["best_client"]
        np.testing.assert_allclose(g.info["scores"], w.info["scores"],
                                   rtol=1e-4)
        assert math.isnan(g.test_acc) == math.isnan(w.test_acc)
        np.testing.assert_allclose(g.test_loss, w.test_loss, rtol=1e-4)
        assert g.round_time_s > 0
    ran = 2 * BLOCK if (pipeline and tau == 0.0) else want_rounds
    assert tserver.rounds_completed == jserver.rounds_completed == ran
    assert tserver.meter.summary() == jserver.meter.summary()
