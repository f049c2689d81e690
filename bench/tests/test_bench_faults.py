"""The comparison that decides ``correct`` must fail: each fault a cell
can have, planted in the port underneath the timed path, and the control
(the reference in TF32, rounded by hand on the CPU) in the program's place.
CPU, tiny sizes, the cells' own limits."""
import time

import pytest
import torch

import bench_tiny
from bench import calibrate, cell, check
from bench.reference import fl

SEED = 2**31 + 4321


def run(spec):
    return cell.run(spec, SEED, 0.2, False, time.perf_counter(), "cpu",
                    "batched")


def keep_state(monkeypatch):
    """The server keeps the old global model."""
    from repro_torch.core import engine
    fx, fa = engine.make_batched_fedx_round, engine.make_batched_fedavg_round

    def fedx(*a, **k):
        rf = fx(*a, **k)
        return lambda gp, d, m, keys: (gp, *rf(gp, d, m, keys)[1:])

    def fedavg(*a, **k):
        rf = fa(*a, **k)
        return lambda gp, d, m, keys: (gp, rf(gp, d, m, keys)[1])

    monkeypatch.setattr(engine, "make_batched_fedx_round", fedx)
    monkeypatch.setattr(engine, "make_batched_fedavg_round", fedavg)


def skip_sgd(monkeypatch):
    """A client's SGD returns its state unchanged."""
    from repro_torch.core import client
    monkeypatch.setattr(client, "make_local_sgd",
                        lambda task, hp: lambda p, d, k, mask=None: p)


def half_batch(monkeypatch):
    """The loss is the mean over the first half of each batch."""
    from repro_torch.core.client import Task
    from repro_torch.data import synthetic
    for name in ("cnn_task", "mlp_task"):
        orig = getattr(synthetic, name)

        def make(*a, _orig=orig, **k):
            t = _orig(*a, **k)

            def loss_fn(p, b):
                h = b["labels"].shape[0] // 2
                return t.loss_fn(p, {k: (v if k == "rng" else v[:h])
                                     for k, v in b.items()})
            return Task(t.init_params, loss_fn)
        monkeypatch.setattr(synthetic, name, make)


def altered_answer(monkeypatch):
    """FedBWO's winner reported one client on; FedAvg's participants
    reported in reverse."""
    from repro_torch.core import engine
    fx, fp = engine.make_batched_fedx_round, engine._fedavg_participants

    def fedx(*a, **k):
        rf = fx(*a, **k)

        def round_fn(gp, d, m, keys):
            p, s, best = rf(gp, d, m, keys)
            return p, s, (best + 1) % s.shape[0]
        return round_fn

    def participants(*a, **k):
        avg, scores, sel = fp(*a, **k)
        return avg, scores, sel.flip(0)

    monkeypatch.setattr(engine, "make_batched_fedx_round", fedx)
    monkeypatch.setattr(engine, "_fedavg_participants", participants)


@pytest.mark.parametrize("fault", [keep_state, skip_sgd, half_batch,
                                   altered_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("model, strategy", [("mlp", "fedbwo"),
                                             ("cnn", "fedavg")])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, model, strategy):
    fault(monkeypatch)
    out = run(bench_tiny.spec(model, strategy))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("model, strategy", [("mlp", "fedbwo"),
                                             ("cnn", "fedavg")])
def test_the_control_is_not_correct(model, strategy):
    spec = bench_tiny.spec(model, strategy)
    found = dict(calibrate.readings(spec, SEED, "cpu"))
    assert not check.judge(found["control"], spec.limits)[0], \
        found["control"]
    for kind, numbers in found.items():
        assert not check.judge(numbers, spec.limits)[0], kind


# the 50-client cell's limits, on the tiny CNN FedBWO run of 3 clients
MANY = {"model": "cnn", "strategy": "fedbwo", "name": "cnn-fedbwo-50c"}


def test_a_sound_run_is_correct_under_the_50_client_limits():
    assert run(bench_tiny.spec(**MANY))["correct"]


def tail_scores(monkeypatch):
    """The last tenth of the clients (at least one) report a score 10 %
    off: a wrong result in the tail chunk of the vmapped batch."""
    from repro_torch.core import engine
    fx = engine.make_batched_fedx_round

    def fedx(*a, **k):
        rf = fx(*a, **k)

        def round_fn(gp, d, m, keys):
            p, s, best = rf(gp, d, m, keys)
            t = fl.tail_size(s.shape[0])
            return p, torch.cat([s[:-t], s[-t:] * 1.1]), best
        return round_fn

    monkeypatch.setattr(engine, "make_batched_fedx_round", fedx)


def test_a_fault_in_the_last_clients_fails_the_50_client_limits(monkeypatch):
    """The median client does not see it; the worst tenth does."""
    tail_scores(monkeypatch)
    rows = run(bench_tiny.spec(**MANY))["checks"]
    assert rows["score_gap_median"]["value"] <= \
        rows["score_gap_median"]["limit"]
    assert rows["score_gap_p90"]["value"] > rows["score_gap_p90"]["limit"]


@pytest.mark.parametrize("fault", [keep_state, skip_sgd, half_batch,
                                   altered_answer], ids=lambda f: f.__name__)
def test_a_planted_fault_fails_the_50_client_limits(monkeypatch, fault):
    fault(monkeypatch)
    out = run(bench_tiny.spec(**MANY))
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_50_client_limits():
    spec = bench_tiny.spec(**MANY)
    kinds = set()
    for kind, numbers in calibrate.readings(spec, SEED, "cpu"):
        assert not check.judge(numbers, spec.limits)[0], kind
        kinds.add(kind)
    assert "tail_skip_sgd" in kinds
