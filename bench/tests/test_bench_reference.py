"""The plain reference against the port, on the CPU at tiny sizes: its
threefry draws against the port's, and whole runs of the harness (the
port's fused blocks on the batched engine) that the reference must find
correct."""
import time

import numpy as np
import pytest
import torch

import bench_tiny
from bench import cell
from bench.reference import threefry as tf

SEED = 2**31 + 977


def test_threefry_matches_the_port():
    from repro_torch import random as R
    k, kr = R.PRNGKey(SEED, "cpu"), tf.key_from_seed(SEED)
    assert R.split(k, 7).tolist() == [list(x) for x in tf.split(kr, 7)]
    assert np.array_equal(R.bits(k, (3, 130)).numpy(), tf.bits(kr, (3, 130)))
    assert np.array_equal(R.randint(k, (6,), 0, 3).numpy(),
                          tf.randint(kr, (6,), 0, 3))
    assert np.array_equal(R.bernoulli(k, 0.8, (10, 16)).numpy(),
                          tf.bernoulli(kr, 0.8, (10, 16)))
    assert np.array_equal(R.permutation(k, 10).numpy(),
                          tf.permutation(kr, 10))
    # erfinv in float64 against the port's float32 polynomial
    a = R.normal(k, (4, 1000)).double()
    assert torch.allclose(a, tf.normal(kr, (4, 1000), "cpu"), atol=2e-5)


@pytest.mark.parametrize("model, strategy", [("mlp", "fedbwo"),
                                             ("cnn", "fedbwo"),
                                             ("cnn", "fedavg")])
def test_a_sound_run_is_correct(model, strategy):
    spec = bench_tiny.spec(model, strategy)
    out = cell.run(spec, SEED, 0.2, False, time.perf_counter(), "cpu",
                   "batched")
    assert not bench_tiny.sound(out["numbers"], spec), out["numbers"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec.limits)

