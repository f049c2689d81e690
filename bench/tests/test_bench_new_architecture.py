"""A new architecture as files alone: a toy next-token configuration
(``toy_next_token.py``: int tokens, per-position labels, its own leaves,
data and loss) goes through the harness as it is, with no file of the
harness edited: ``make_inputs``, ``port.build``, a set-up block and the
window's blocks, and ``check.py``'s comparison.  A sound run is correct;
a client step that returns its state, and a loss over half of each
batch, are not.  CPU, seconds."""
import sys
import time

import pytest

import bench_tiny
import toy_next_token
from bench import cell, check, data, port
from bench.reference import fl

SEED = 2**31 + 2024


@pytest.fixture
def toy(monkeypatch):
    """The toy registered where the harness looks for a model by name."""
    name = toy_next_token.CONFIG["model"]
    for pkg in ("bench.models", "bench.ports"):
        monkeypatch.setitem(sys.modules, f"{pkg}.{name}", toy_next_token)
    return toy_next_token


def toy_spec(strategy: str) -> cell.Spec:
    """The tiny mix of the strategy's cell (3 clients of 2 batches, blocks
    of 2 rounds) on the toy, held to the tiny run's gap."""
    real = bench_tiny.spec("mlp" if strategy == "fedbwo" else "cnn",
                           strategy)
    limits = {k: 0 if k.endswith(("_miss", "_off")) else bench_tiny.TINY_GAP
              for k in real.limits}
    return cell.Spec(real.workload, dict(toy_next_token.CONFIG),
                     real.traffic, real.end_to_end, real.per_layer,
                     real.follow_rounds, limits)


def run(spec):
    return cell.run(spec, SEED, 0.2, False, time.perf_counter(), "cpu",
                    "batched")


def test_inputs_are_the_models_own(toy):
    spec = toy_spec("fedbwo")
    inputs = data.make_inputs(spec.cfg, spec.traffic, SEED, "cpu")
    B, S = spec.traffic["batch_size"], spec.cfg["seq"]
    assert len(inputs.clients) == spec.traffic["n_clients"]
    for c in inputs.clients:
        assert set(c) == {"tokens", "labels"}
        assert c["tokens"].shape == c["labels"].shape == (2, B, S)
    assert inputs.eval["tokens"].shape == (spec.traffic["n_test"], S)
    # the embedding at unit scale (its full name), the layers at 1/width
    V, d = spec.cfg["vocab"], spec.cfg["width"]
    emb, rest = inputs.weights[:V * d], inputs.weights[V * d:]
    assert 0.7 < float(emb.std()) < 1.3
    assert float(rest.abs().max()) < 6 * d ** -0.5
    tree = port.weights_tree(port.port_task(spec.cfg), toy.layout(spec.cfg),
                             inputs.weights)
    assert set(tree) == {"embed", "fc", "out"}


def test_fan_in_by_full_name_or_prefix():
    fan = {"layers": 4, "layers.0": 8, "layers.0.attn.wq": 16}
    assert data.leaf_fan_in(fan, "layers.0.attn.wq") == 16
    assert data.leaf_fan_in(fan, "layers.0.attn.wk") == 8
    assert data.leaf_fan_in(fan, "layers.1.mlp.w") == 4
    with pytest.raises(KeyError):
        data.leaf_fan_in(fan, "embed.w")


def test_the_reference_learns_the_chain(toy):
    spec = toy_spec("fedavg")
    inputs = data.make_inputs(spec.cfg, spec.traffic, SEED, "cpu")
    model = fl.Model(spec.cfg, "cpu", fl.Precision("float64"))
    t = dict(spec.traffic, lr=0.5)
    infos, _ = check.reference_rounds(model, inputs, SEED, t, 2)
    start = model.evaluate(inputs.weights.double(), inputs.eval)[0]
    assert infos[-1]["eval_loss"] < start


@pytest.mark.parametrize("strategy", ["fedbwo", "fedavg"])
def test_a_sound_run_is_correct(toy, strategy):
    out = run(toy_spec(strategy))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0


def skip_sgd(monkeypatch, toy):
    """A client's SGD returns its state unchanged."""
    from repro_torch.core import client
    monkeypatch.setattr(client, "make_local_sgd",
                        lambda task, hp: lambda p, d, k, mask=None: p)


def half_batch(monkeypatch, toy):
    """The port's loss over the first half of each batch."""
    whole = toy.port_loss

    def loss(params, batch):
        h = batch["tokens"].shape[0] // 2
        return whole(params, {k: (v if k == "rng" else v[:h])
                              for k, v in batch.items()})
    monkeypatch.setattr(toy, "port_loss", loss)


@pytest.mark.parametrize("fault", [skip_sgd, half_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("strategy", ["fedbwo", "fedavg"])
def test_a_planted_fault_is_not_correct(monkeypatch, toy, fault, strategy):
    fault(monkeypatch, toy)
    out = run(toy_spec(strategy))
    assert not out["correct"], out["checks"]
