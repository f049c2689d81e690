"""On the card (skipped without one): a tiny traced run of each kind
agrees with the reference, and the control in its real TF32 fails the
cell's limits.  Run on the chip with

    python3 -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import time

import pytest

import bench_tiny
from bench import calibrate, cell, check

SEED = 2**31 + 55


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("model, strategy", [("mlp", "fedbwo"),
                                             ("cnn", "fedbwo"),
                                             ("cnn", "fedavg")])
def test_tiny_runs_on_the_card(card, model, strategy):
    # the cells' own learning rate: at the tiny mix's 0.3, four SGD steps
    # grew the card's float32 rounding past the tiny tolerance in one run
    # of three
    lr = cell.load_spec(bench_tiny.CELL[(model, strategy)]).traffic["lr"]
    spec = bench_tiny.spec(model, strategy, lr=lr)
    out = cell.run(spec, SEED, 0.5, True, time.perf_counter(), card)
    assert not bench_tiny.sound(out["numbers"], spec), out["numbers"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("model, strategy", [("mlp", "fedbwo"),
                                             ("cnn", "fedavg")])
def test_the_control_fails_on_the_card(card, model, strategy):
    spec = bench_tiny.spec(model, strategy)
    found = dict(calibrate.readings(spec, SEED, card))
    for kind, numbers in found.items():
        assert not check.judge(numbers, spec.limits)[0], kind
