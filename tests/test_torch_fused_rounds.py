"""Fused rounds in the port against the reference, and against the port's
own single rounds, on the CPU.

(a) ``Server.run_block(R)`` of both packages on the toy task (conftest's
``make_toy_task``, its weights carried across by
``convert.params_from_jax``), IID and Dirichlet (ragged, pad+mask)
splits, FedBWO composed and on the kernel route (the reference's Pallas
kernel in interpret mode, the port's plain version), FedAvg at C = 1 and
C = 0.6, under "vmap" and "scan", with an eval cadence of 2: the same
winners or participants, scores within rtol 1e-4, the global parameters
within rtol 1e-4 and atol 1e-5, equal ``CommMeter`` ledgers and the same
rounds evaluated.  (b) A port block against R port ``run_round`` calls:
bit for bit in params, scores, winners, the rng carry and the ledger, as
the reference's own ``tests/test_fused_rounds.py`` requires.  (c) A block
reads nothing on the host, which a CUDA graph capture needs.  (d) The
"auto" table, the sequential fallbacks and ``build_experiment`` on the
narrow paper CNN with ``rounds_per_dispatch=2``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import ClientHP as JClientHP, Server as JServer  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.server import get_strategy as jget  # noqa: E402
from repro.data.synthetic import cnn_task as jcnn_task  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.client import ClientHP  # noqa: E402
from repro_torch.core.engine import eval_due, make_fused_rounds  # noqa: E402
from repro_torch.core.knobs import DEFAULT_ROUNDS_PER_DISPATCH  # noqa: E402
from repro_torch.core.protocol import StopConditions, run_federated  # noqa: E402
from repro_torch.core.server import Server, get_strategy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

from conftest import make_toy_data, make_toy_task  # noqa: E402
from test_torch_engine import (HP, NARROW, STRATEGIES, dirichlet_clients,  # noqa: E402
                               iid_clients, labeled_toy_task, to_torch,
                               torch_toy_task)

BLOCK = 3
EVERY = 2


def toy_eval(label):
    d = make_toy_data(jax.random.PRNGKey(7), 60)
    return {"x": d["x"], label: d["y"]}


def toy_pair(case, vectorize, split, rounds_per_dispatch=BLOCK):
    """A reference and a port server on the same toy clients, both on the
    batched engine, and the eval batch in both packages' form."""
    strategy, kernel, ratio = STRATEGIES[case]
    if split == "iid":
        jtask, label, jclients = make_toy_task(), "y", iid_clients()
    else:
        jtask, label, jclients = (labeled_toy_task(), "labels",
                                  dirichlet_clients())
    jkw = {"use_pallas": True} if kernel else {}
    tkw = {"use_kernel": True} if kernel else {}
    jserver = JServer(jtask, jget(strategy, client_ratio=ratio, **jkw),
                      JClientHP(vectorize=vectorize, **HP), jclients,
                      jax.random.PRNGKey(3), engine="batched",
                      rounds_per_dispatch=rounds_per_dispatch)
    tserver = Server(torch_toy_task(jtask, label),
                     get_strategy(strategy, client_ratio=ratio, **tkw),
                     ClientHP(vectorize=vectorize, **HP), to_torch(jclients),
                     R.PRNGKey(3, "cpu"), engine="batched",
                     rounds_per_dispatch=rounds_per_dispatch)
    jeval = toy_eval(label)
    return jserver, tserver, jeval, to_torch([jeval])[0]


def assert_params_close(tserver, jserver):
    for g, w in zip(tree.leaves(tserver.global_params),
                    jax.tree.leaves(jserver.global_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def assert_infos_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["engine"] == w["engine"] == "fused"
        for k in ("best_client", "participants"):
            assert g.get(k) == w.get(k)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4)
        assert ("eval_acc" in g) == ("eval_acc" in w)
        if "eval_acc" in g:
            np.testing.assert_allclose(g["eval_loss"], w["eval_loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(g["eval_acc"], w["eval_acc"],
                                       atol=1e-6)


# ------------------------------------------- (a) against the reference --
@pytest.mark.parametrize("split", ["iid", "dirichlet"])
@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
@pytest.mark.parametrize("case", list(STRATEGIES))
def test_run_block_matches_reference(case, vectorize, split):
    jserver, tserver, jeval, teval = toy_pair(case, vectorize, split)
    assert tserver._engine.padded == (split == "dirichlet")
    want = jserver.run_block(BLOCK, eval_data=jeval, eval_every=EVERY)
    got = tserver.run_block(BLOCK, eval_data=teval, eval_every=EVERY)
    assert [("eval_acc" in i) for i in got] == [False, True, True]
    assert_infos_close(got, want)
    assert_params_close(tserver, jserver)
    assert tserver.meter.summary() == jserver.meter.summary()
    assert tserver.meter.kinds == jserver.meter.kinds
    np.testing.assert_array_equal(tserver.rng.numpy(),
                                  np.asarray(jserver.rng).astype(np.int64))
    assert tserver.rounds_completed == jserver.rounds_completed == BLOCK


def test_eval_cadence_is_global_across_blocks():
    """A second block starts at round 3: the cadence counts from the run's
    start (rounds 4 and 6 in 1-based terms), and the last round of each
    block always evaluates, as in the reference."""
    jserver, tserver, jeval, teval = toy_pair("fedbwo", "scan", "iid")
    for _ in range(2):
        want = jserver.run_block(BLOCK, eval_data=jeval, eval_every=EVERY)
        got = tserver.run_block(BLOCK, eval_data=teval, eval_every=EVERY)
        assert_infos_close(got, want)
    assert [("eval_acc" in i) for i in got] == [True, False, True]
    assert eval_due(3, 2, 3) == (True, False, True)
    assert eval_due(3, 0, 0) == (False, False, False)
    assert eval_due(2, 5, 0) == (False, True)


# -------------------------------------- (b) against the port's rounds --
def twin_servers(case, split="iid", vectorize="vmap"):
    _, single, _, teval = toy_pair(case, vectorize, split, 1)
    _, fused, _, _ = toy_pair(case, vectorize, split, BLOCK)
    return single, fused, teval


def assert_bitexact(single, fused, infos_s, infos_f):
    for a, b in zip(tree.leaves(single.global_params),
                    tree.leaves(fused.global_params)):
        assert torch.equal(a, b)
    assert torch.equal(single.rng, fused.rng)
    for a, b in zip(infos_s, infos_f):
        for k in ("best_client", "score", "participants", "scores"):
            assert a.get(k) == b.get(k)      # floats bit for bit
    assert single.meter.summary() == fused.meter.summary()
    assert single.meter.uplink == fused.meter.uplink
    assert single.meter.downlink == fused.meter.downlink
    assert single.meter.kinds == fused.meter.kinds


@pytest.mark.parametrize("split", ["iid", "dirichlet"])
@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
@pytest.mark.parametrize("case", list(STRATEGIES))
def test_fused_block_bitexact_vs_single_rounds(case, vectorize, split):
    single, fused, _ = twin_servers(case, split, vectorize)
    infos_s = [single.run_round() for _ in range(BLOCK)]
    infos_f = fused.run_block(BLOCK)
    assert [i["engine"] for i in infos_f] == ["fused"] * BLOCK
    assert_bitexact(single, fused, infos_s, infos_f)
    # ...and a later single round on the fused server still matches
    assert single.run_round() == fused.run_round()


def test_eval_in_the_block_equals_evaluate():
    """The block's eval_loss / eval_acc equal ``Server.evaluate`` on a twin
    server at the same round, bit for bit."""
    single, fused, teval = twin_servers("fedbwo")
    infos = fused.run_block(BLOCK, eval_data=teval, eval_every=EVERY)
    for info in infos:
        single.run_round()
        if "eval_acc" in info:
            assert (info["eval_loss"], info["eval_acc"]) == \
                single.evaluate(teval)


def test_run_federated_fused_driver_matches_single_rounds():
    """Through ``run_federated``: the same curve with R = 3 as with 1 (tau
    never reached), and the leftover rounds (7 = 2 x 3 + 1) on the
    single-round path, so only one block shape is built."""
    logs = {}
    for rpd in (1, BLOCK):
        _, server, _, teval = toy_pair("fedbwo", "vmap", "iid", rpd)
        server.pipeline_blocks = False
        logs[rpd] = run_federated(server, teval, StopConditions(
            max_rounds=7, patience=100, tau=1.1))
        if rpd > 1:
            assert list(server._engine._fused) == [(BLOCK, 1)]
    assert [l.info["engine"] for l in logs[BLOCK]] == \
        ["fused"] * 6 + ["batched"]
    for a, b in zip(logs[1], logs[BLOCK]):
        assert (a.test_loss, a.test_acc) == (b.test_loss, b.test_acc)
        assert a.info["scores"] == b.info["scores"]


# ------------------------------------------ (c) nothing read on host --
class HostReads(TorchDispatchMode):
    """Records every op that reads a tensor on the host or builds one from
    host data: each is a sync (or a copy from pageable memory) on the
    card, which a CUDA graph capture refuses."""
    HOST = ("_local_scalar_dense", "nonzero", "masked_select", "is_nonzero",
            "equal", "lift_fresh", "lift_fresh_copy", "item")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.HOST:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
@pytest.mark.parametrize("strategy,kw", [
    ("fedbwo", {}), ("fedbwo", {"use_kernel": True}), ("fedpso", {}),
    ("fedgwo", {}), ("fedsca", {}), ("fedavo", {}),
    ("fedavg", {"client_ratio": 0.6})])
def test_fused_block_reads_nothing_on_the_host(strategy, kw, vectorize):
    """The whole block, eval included, on a ragged (masked) split, issues
    no op that reads a tensor on the host: what the card's capture of a
    block needs, checked here by the ops the block dispatches."""
    jtask = labeled_toy_task()
    clients = to_torch(dirichlet_clients())
    server = Server(torch_toy_task(jtask, "labels"),
                    get_strategy(strategy, **kw),
                    ClientHP(vectorize=vectorize, **HP), clients,
                    R.PRNGKey(3, "cpu"), engine="batched")
    engine = server._engine
    assert engine.padded
    block = make_fused_rounds(server.task, server.strategy, server.hp, 2,
                              n_clients=engine.n_clients, device="cpu",
                              vectorize=vectorize, eval_every=1)
    teval = to_torch([toy_eval("labels")])[0]
    with HostReads() as rec:
        params, rng, logs = block(server.global_params, server.rng,
                                  engine.data, engine.mask, teval, 0)
    assert rec.seen == []
    # each round's logs, and the block's span stamps (spans are on)
    assert "spans" in logs
    assert all(v.shape[0] == 2 for k, v in logs.items() if k != "spans")


def test_host_reads_sees_a_host_read():
    """The positive control: indexing by a 0-dim tensor reads it on the
    host; the same gather by ``index_select`` does not."""
    from repro_torch.metaheuristics.base import take
    a, i = torch.arange(6.0).reshape(3, 2), torch.tensor(1)
    with HostReads() as rec:
        a[i]
    assert rec.seen == ["aten._local_scalar_dense.default"]
    with HostReads() as rec:
        got = take(a, i)
    assert rec.seen == [] and torch.equal(got, a[1])


# ------------------------------------ (d) knobs, fallbacks, the facade --
@pytest.mark.parametrize("engine,task,want", [
    ("batched", "mlp", (DEFAULT_ROUNDS_PER_DISPATCH, True)),
    ("auto", "mlp", (DEFAULT_ROUNDS_PER_DISPATCH, True)),
    ("auto", "cnn", (1, False)),          # the CPU's conv policy
    ("sequential", "mlp", (1, False))])
def test_auto_resolves_as_the_reference(engine, task, want):
    kw = dict(task=task, n_clients=2, n_train=20, n_test=10, engine=engine,
              rounds_per_dispatch="auto")
    server = api.build_experiment(api.FLConfig(device="cpu", **kw)).server
    jserver = japi.build_experiment(japi.FLConfig(**kw)).server
    assert server.engine == jserver.engine
    got = (server.rounds_per_dispatch, server.pipeline_blocks)
    assert got == (jserver.rounds_per_dispatch, jserver.pipeline_blocks) \
        == want


def test_sequential_run_block_fallback_and_dispatch_raises():
    """On the sequential engine run_block is a loop of run_round plus the
    cadenced evaluate (the reference's info shapes and eval rounds), and
    dispatch_block raises, as the reference's does."""
    jclients = iid_clients()
    seq = Server(torch_toy_task(make_toy_task(), "y"),
                 get_strategy("fedbwo"), ClientHP(**HP), to_torch(jclients),
                 R.PRNGKey(3, "cpu"), engine="sequential",
                 rounds_per_dispatch="auto")
    jseq = JServer(make_toy_task(), jget("fedbwo"), JClientHP(**HP),
                   jclients, jax.random.PRNGKey(3), engine="sequential")
    assert seq.rounds_per_dispatch == 1 and seq.pipeline_blocks is False
    infos = seq.run_block(3, eval_data=to_torch([toy_eval("y")])[0],
                          eval_every=2)
    want = jseq.run_block(3, eval_data=toy_eval("y"), eval_every=2)
    assert [("eval_acc" in i) for i in infos] == \
        [("eval_acc" in i) for i in want] == [False, True, True]
    for g, w in zip(infos, want):
        assert g["engine"] == w["engine"] == "sequential"
        assert g["best_client"] == w["best_client"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4)
    assert len(seq.meter.uplink) == 3
    with pytest.raises(RuntimeError, match="batched engine"):
        seq.dispatch_block(2)


@pytest.mark.parametrize("pipeline", ["off", "auto"])
def test_build_experiment_narrow_cnn_two_rounds_a_dispatch(pipeline):
    """``build_experiment`` with ``rounds_per_dispatch=2`` on the narrow
    paper CNN, batched, 4 rounds (two blocks), serial and pipelined,
    against the reference's."""
    settings = dict(n_clients=3, n_train=90, n_test=30, mh_pop=3,
                    mh_generations=1, local_epochs=1, max_rounds=4,
                    engine="batched", rounds_per_dispatch=2,
                    pipeline_blocks=pipeline, tau=1.01)
    want = japi.build_experiment(
        japi.FLConfig(**settings),
        task=jcnn_task(JCNNConfig(**NARROW))).run()
    got = api.build_experiment(
        api.FLConfig(device="cpu", **settings),
        task=synthetic.cnn_task(CNNConfig(**NARROW))).run()
    summary = got.summary()
    assert summary["rounds_per_dispatch"] == 2
    assert summary["pipeline_blocks"] == (pipeline == "auto")
    assert summary["pipeline_blocks"] == want.summary()["pipeline_blocks"]
    assert len(got.logs) == len(want.logs) == 4
    for g, w in zip(got.logs, want.logs):
        assert g.info["engine"] == w.info["engine"] == "fused"
        assert g.info["best_client"] == w.info["best_client"]
        np.testing.assert_allclose(g.info["scores"], w.info["scores"],
                                   rtol=1e-4)
        np.testing.assert_allclose(g.test_loss, w.test_loss, rtol=1e-4)
        assert math.isfinite(g.round_time_s) and g.round_time_s > 0
    assert got.server.meter.summary() == want.server.meter.summary()
    assert summary["block_timing"]["blocks"] == 2
