"""The span recorder (``repro_torch.spans``) on the CPU, and on the card.

CPU: a fused block of FedBWO (the kernel route's plain version) and one of
FedAvg at tiny sizes, on the paper CNN's layers cut small (dropout, so the
local SGD draws), under "vmap" and "scan": one ``round`` span a round with
its ``sgd``, ``fitness`` and ``threefry`` spans inside; the trained and
fitness samples they count equal ``bench/counts.py::round_samples`` for
both of the benchmark's traffic mixes at those sizes; spans on and off give
bit-identical results, and off the logs hold no ``spans`` entry; the stamps
survive the block's float64 log copy; the log stays bounded; the host
spans and ranges show in a profiler trace.

Card (``cuda``; skipped without one): a captured block replayed under
``torch.profiler`` runs one ``fl_span_stamp`` kernel a stamp, and one
offset and one rate map every stamp onto its kernel's start within 5 us;
the strict audit passes with spans on and finds a stamp kernel node for
every stamp.  Run there without the JAX-importing
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_spans.py
"""
import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench import counts, data, port  # noqa: E402
from repro_torch import spans, tree  # noqa: E402
from repro_torch.core.api import FLConfig, build_experiment  # noqa: E402
from repro_torch.core.client import Task  # noqa: E402
from repro_torch.core.server import _fetch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7
R = 2
TINY_CNN = {"name": "tiny-cnn", "model": "cnn", "task": "cnn",
            "image_size": 8, "channels": 3, "conv1_filters": 4,
            "conv2_filters": 8, "kernel": 5, "dense_hidden": 16,
            "num_classes": 10, "dropout": 0.2}
MIXES = {"fedbwo": "fedbwo-iid-1k", "fedavg": "fedavg-iid-10k"}


def tiny_traffic(strategy: str) -> dict:
    """The benchmark's mix for ``strategy`` at a tiny size: 3 clients of 2
    batches, 2 epochs, pop 3, 2 generations, blocks of ``R`` rounds."""
    mix = json.loads((ROOT / "bench" / "traffic"
                      / f"{MIXES[strategy]}.json").read_text())
    return dict(mix, n_clients=3, n_train=60, n_test=20, mh_pop=3,
                mh_generations=2, rounds_per_dispatch=R)


def build(strategy: str, vectorize: str, spans_on: bool = True):
    """The port's experiment at the tiny mix on the CPU's batched engine,
    with the benchmark's inputs and weights."""
    cfg, traffic = TINY_CNN, tiny_traffic(strategy)
    inputs = data.make_inputs(cfg, traffic, SEED, "cpu")
    base = port.port_task(cfg)
    params = port.weights_tree(base, counts.model_module(cfg).layout(cfg),
                               inputs.weights)
    fl = FLConfig(strategy=strategy, task="cnn",
                  n_clients=traffic["n_clients"],
                  n_train=traffic["n_train"], n_test=traffic["n_test"],
                  batch_size=traffic["batch_size"],
                  local_epochs=traffic["local_epochs"], lr=traffic["lr"],
                  mh_pop=traffic["mh_pop"],
                  mh_generations=traffic["mh_generations"],
                  engine="batched", vectorize=vectorize,
                  rounds_per_dispatch=R, server_seed=SEED, device="cpu",
                  bwo_kernel=traffic["bwo_kernel"], spans=spans_on)
    hp = dataclasses.replace(fl.client_hp(),
                             fitness_batches=traffic["fitness_batches"])
    task = Task(lambda key: tree.map(torch.clone, params), base.loss_fn)
    exp = build_experiment(fl, task=task, client_data=inputs.clients,
                           eval_data=inputs.eval, hp=hp)
    return exp, traffic


@pytest.fixture(scope="module")
def blocks():
    """The spans of one block of each strategy and client-axis mode."""
    out = {}
    for strategy in MIXES:
        for vectorize in ("vmap", "scan"):
            exp, traffic = build(strategy, vectorize)
            exp.server.run_block(R, exp.eval_data, 1)
            block = spans.BLOCKS[-1]
            assert block.owner == exp.server._engine.span_owner
            out[strategy, vectorize] = (block, traffic)
    return out


CASES = [(s, v) for s in MIXES for v in ("vmap", "scan")]


@pytest.mark.parametrize("strategy, vectorize", CASES)
def test_each_round_has_one_round_span_with_its_children(blocks, strategy,
                                                         vectorize):
    block, traffic = blocks[strategy, vectorize]
    sp = block.spans
    rounds = [i for i, s in enumerate(sp) if s.name == "round"]
    assert [sp[i].round for i in rounds] == list(range(R))
    assert all(sp[i].parent is None for i in rounds)
    clients = 1 if vectorize == "vmap" else traffic["n_clients"]
    batches = traffic["n_train"] // traffic["n_clients"] // \
        traffic["batch_size"]
    G = traffic["mh_generations"]
    for r, i in zip(range(R), rounds):
        inside = [(j, s) for j, s in enumerate(sp)
                  if s.round == r and j != i]
        assert {s.name for _, s in inside} == {"sgd", "fitness", "threefry"}
        for j, s in inside:
            p = sp[s.parent]
            assert s.parent < j and p.round == r
            assert p.begin_ns <= s.begin_ns <= s.end_ns <= p.end_ns
        by = collections.Counter(
            (s.name, sp[s.parent].name) for _, s in inside)
        # the dropout draws: one a step, inside the local SGD
        want = {("sgd", "round"): clients,
                ("threefry", "sgd"): clients * traffic["local_epochs"] *
                batches}
        if strategy == "fedbwo":
            # the seeding's fitness and normal noise; each generation's
            # children scored, its two parent picks (randint draws twice),
            # its two bit planes and its gate
            want[("fitness", "round")] = clients * (1 + G)
            want[("threefry", "round")] = clients * (1 + 7 * G)
        else:
            # the score, and the participants' permutation
            want[("fitness", "round")] = clients
            want[("threefry", "round")] = 1
        assert by == want


@pytest.mark.parametrize("strategy, vectorize", CASES)
def test_the_counted_samples_are_the_benchmarks(blocks, strategy, vectorize):
    block, traffic = blocks[strategy, vectorize]
    want = counts.round_samples(traffic)
    for r in range(R):
        got = collections.Counter()
        for s in block.spans:
            if s.round == r and s.name in ("sgd", "fitness"):
                got[s.name] += s.count
        assert got == {"sgd": want["trained"], "fitness": want["fitness"]}
        draws = [s.count for s in block.spans
                 if s.round == r and s.name == "threefry"]
        assert all(c > 0 for c in draws)


@pytest.mark.parametrize("strategy", list(MIXES))
def test_spans_on_and_off_give_the_same_results(strategy):
    runs = {}
    for on in (True, False):
        exp, _ = build(strategy, "vmap", spans_on=on)
        eng, server = exp.server._engine, exp.server
        params, rng, logs = eng.run_block(server.global_params, server.rng,
                                          R, exp.eval_data, 1, 0)
        assert ("spans" in logs) == on
        assert (eng.block_spans is not None) == on
        server.global_params, server.rng = params, rng
        infos = server.run_block(R, exp.eval_data, 1)
        runs[on] = (tree.leaves(server.global_params), server.rng,
                    {k: v for k, v in logs.items() if k != "spans"}, infos)
    (p1, rng1, logs1, infos1), (p0, rng0, logs0, infos0) = runs[True], \
        runs[False]
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))
    assert torch.equal(rng1, rng0)
    assert logs1.keys() == logs0.keys()
    assert all(torch.equal(logs1[k], logs0[k]) for k in logs1)
    assert infos1 == infos0


def test_stamps_survive_the_blocks_float64_log_copy():
    """The device timer reads about 1.8e18 ns; as int32 words the block's
    one float64 copy carries each stamp exactly."""
    stamps = torch.tensor([1_760_000_000_123_456_789, 1_760_000_000_123_457_790,
                           2**62 + 2**31 + 5, 7], dtype=torch.int64)
    schema = (spans.Slot("round", None, 0, None, 0, 3),
              spans.Slot("sgd", 0, 0, 40, 1, 2))
    other = torch.arange(3, dtype=torch.float32)
    _, words = _fetch(other, stamps.view(torch.int32))
    got = spans.decode(schema, words, 10)
    assert [(s.begin_ns, s.end_ns) for s in got] == \
        [(int(stamps[0]), 7), (int(stamps[1]), int(stamps[2]))]
    assert [(s.round, s.parent, s.count) for s in got] == \
        [(10, None, None), (10, 0, 40)]


def test_a_span_outside_a_recording_records_nothing():
    from repro_torch import random
    assert spans.span("sgd", 3) is spans.span("fitness")
    with spans.recording("cpu") as rec:
        with spans.span("round", round=0), spans.batched(4):
            random.uniform(random.PRNGKey(0, "cpu"), (5,))
    random.uniform(random.PRNGKey(0, "cpu"), (5,))
    words, schema = rec.finish()
    assert [(s.name, s.parent, s.round, s.count) for s in schema] == \
        [("round", None, 0, None), ("threefry", 0, 0, 20)]
    assert words.dtype == torch.int32 and words.numel() == 2 * 4
    stamps = spans.decode(schema, words.numpy(), 0)
    assert stamps[0].begin_ns <= stamps[1].begin_ns <= stamps[1].end_ns \
        <= stamps[0].end_ns


def test_the_log_stays_bounded(monkeypatch):
    from collections import deque
    monkeypatch.setattr(spans, "BLOCKS", deque(maxlen=spans.BLOCKS_KEPT))
    monkeypatch.setattr(spans, "SETUP", deque(maxlen=spans.BLOCKS_KEPT))
    schema = (spans.Slot("round", None, 0, None, 0, 1),)
    words = np.array([5, 0, 9, 0], dtype=np.float64)
    for k in range(spans.BLOCKS_KEPT + 10):
        spans.record_block(3, k, schema, words)
        with spans.host("capture", 3):
            pass
    assert len(spans.BLOCKS) == len(spans.SETUP) == spans.BLOCKS_KEPT
    assert spans.BLOCKS[-1].round_offset == spans.BLOCKS_KEPT + 9
    assert spans.BLOCKS[-1].spans[0].round == spans.BLOCKS_KEPT + 9
    assert spans.BLOCKS[0].round_offset == 10


def test_host_spans_and_ranges_show_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    exp, _ = build("fedavg", "scan")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.host("warmup", 99) as timed:
            exp.server.run_block(R, exp.eval_data, 1)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("warmup", "dispatch_block", "finish_block",
                              "fetch")}
    assert len(ranges) == 4
    # plain host ranges: a user annotation would be mirrored onto the
    # device's timeline, where it would count as device activity
    assert not any(e.is_user_annotation() for e in ranges.values())
    assert spans.SETUP[-1] == (99, timed.span)
    assert timed.seconds > 0


# ---------------------------------------------------------------- card --
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are a CUDA kernel")


SMALL = dict(strategy="fedbwo", task="mlp", bwo_kernel=True, device="cuda",
             n_clients=3, n_train=90, n_test=30, mh_pop=2,
             mh_generations=1, local_epochs=1, rounds_per_dispatch=2,
             max_rounds=2, tau=1.01)


def _stamps(block, schema):
    """The block's stamps in slot order (launch order)."""
    out = [0] * (2 * len(schema))
    for slot, s in zip(schema, block.spans):
        out[slot.begin], out[slot.end] = s.begin_ns, s.end_ns
    return out


@pytest.mark.cuda
def test_stamps_align_with_their_kernels_on_the_card():
    _card()
    from torch.profiler import ProfilerActivity, profile
    exp = build_experiment(FLConfig(**SMALL))
    server = exp.server
    server.run_block(2, exp.eval_data, 1)          # warm-up, capture, replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.run_block(2, exp.eval_data, 1)
        torch.cuda.synchronize()
    block, schema = spans.BLOCKS[-1], server._engine.block_spans
    stamps = _stamps(block, schema)
    starts = sorted(e.start_ns() for e in
                    prof.profiler.kineto_results.events()
                    if "fl_span_stamp" in e.name())
    assert len(starts) == len(stamps) == 2 * len(block.spans)
    assert stamps == sorted(stamps)
    st = np.array(stamps, dtype=np.int64)
    cu = np.array(starts, dtype=np.int64)
    diffs = st - cu
    offset = int(np.median(diffs))
    off_by = np.abs(diffs - offset)
    x, y = (cu - cu[0]).astype(float), (st - st[0]).astype(float)
    slope, icpt = np.polyfit(x, y, 1)
    linear = np.abs(y - (slope * x + icpt))
    steps = np.diff(np.unique(st))
    print(json.dumps({"stamps": len(stamps), "span_ns": int(x[-1]),
                      "offset_ns": offset, "worst_ns": int(off_by.max()),
                      "rate_ppm": (slope - 1) * 1e6,
                      "linear_worst_ns": float(linear.max()),
                      "timer_step_ns": int(steps.min()),
                      "timer_gcd_ns": int(np.gcd.reduce(steps))}))
    # one offset and one rate: within a profiler session the profiler's
    # device timestamps run at a rate a little off the device timer's
    # (0.03-0.3 % in a loaded block), so an offset alone drifts by tens of
    # microseconds over a block of 40 ms; printed above as worst_ns
    assert linear.max() <= 5_000


@pytest.mark.cuda
def test_the_strict_audit_passes_with_spans_on():
    _card()
    exp = build_experiment(FLConfig(**SMALL), audit="strict")
    report = exp.audit_report
    assert report.ok, report.render()
    (f,) = [f for f in report.findings if f.rule == "one-sync-per-block"
            and f.severity == "info" and f.subject == "block[fedbwo x2]"]
    kernels = f.details["kernels"]
    stamps = sum(c for k, c in kernels.items() if "fl_span_stamp" in k)
    schema = exp.server._engine.fused_rounds(2, 1).span_schema
    assert stamps == 2 * len(schema) > 0
