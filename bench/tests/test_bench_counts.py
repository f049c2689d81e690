"""The benchmark's own arithmetic: D, FLOPs, bwo_evolve's bytes."""
import json

import pytest

from bench import counts
from bench.cell import BENCH

CNN = json.loads((BENCH / "configs" / "paper-cnn.json").read_text())
MLP = json.loads((BENCH / "configs" / "fedavg-2nn.json").read_text())
FEDBWO = json.loads((BENCH / "traffic" / "fedbwo-iid-1k.json").read_text())
FEDAVG = json.loads((BENCH / "traffic" / "fedavg-iid-10k.json").read_text())


@pytest.mark.parametrize("cfg, D", [(CNN, 2_465_322), (MLP, 656_810)])
def test_params_from_shapes(cfg, D):
    assert counts.n_params(cfg) == D


def test_cnn_forward_flops():
    # 4.92 + 18.87 + 26.21 + 18.87 + 4.19 + 0.52 + 0.01 MFLOP, SAME padding
    assert counts.forward_flops(CNN) == 73_607_168
    assert round(counts.forward_flops(CNN) / 1e6, 1) == 73.6


def test_mlp_forward_flops():
    assert counts.forward_flops(MLP) == 2 * (3072 * 200 + 200 * 200 + 2000)


@pytest.mark.parametrize("rows, parents, mb", [(60, 29, 2061.1), (6, 3, 207.1)])
def test_bwo_evolve_bytes_as_perf_counts_them(rows, parents, mb):
    # PERF.md's figure counts both bit planes at the padded width Dp
    D = 2_465_322
    Dp = -(-D // 128) * 128
    got = counts.bwo_evolve_bytes(rows, D, parents, bit_words=Dp)
    assert round(got / 1e6, 1) == mb


def test_bwo_evolve_bytes_read_only_d_words():
    D = 2_465_322
    Dp = -(-D // 128) * 128
    assert counts.bwo_evolve_bytes(60, D, 29, Dp) - \
        counts.bwo_evolve_bytes(60, D, 29) == 4 * 2 * 60 * (Dp - D)


def test_expected_distinct_parents():
    # 12 draws from 3: all three but with probability 3 (2/3)^12 - 3 (1/3)^12
    assert counts.expected_distinct(3, 12) == pytest.approx(
        3 - 3 * (2 / 3) ** 12)
    assert counts.bwo_launch_bytes(CNN, FEDBWO) == pytest.approx(
        counts.bwo_evolve_bytes(60, 2_465_322,
                                10 * counts.expected_distinct(3, 12)))


def test_round_samples():
    assert counts.round_samples(FEDBWO) == {"trained": 2000,
                                            "fitness": 10 * 24 * 20}
    assert counts.round_samples(FEDAVG) == {"trained": 20000,
                                            "fitness": 10 * 20}


def test_rounds_flops():
    t = dict(FEDBWO, rounds_per_dispatch=5)
    f = counts.forward_flops(CNN)
    assert counts.rounds_flops(CNN, t, 5, 10) == 10 * (6000 + 4800 + 300) * f
    t = dict(FEDAVG, rounds_per_dispatch=5)
    assert counts.rounds_flops(CNN, t, 0, 5) == \
        5 * (60000 + 200 + 2000) * f


def test_eval_rounds_cadence():
    t = dict(FEDBWO, rounds_per_dispatch=5, eval_every=3)
    # rounds 1..10: every third (3, 6, 9) and each block's last (5, 10)
    assert counts.eval_rounds(t, 0, 10) == 5


def test_bwo_constants_are_the_ports_defaults():
    """The port takes no BWO constant from ``FLConfig``: it runs
    ``bwo()``'s defaults and seeds with ``init_population``'s spread, so
    the reference's constants have to be those."""
    import inspect

    from bench.reference.fl import BWO
    from repro_torch.metaheuristics.base import init_population
    from repro_torch.metaheuristics.bwo import bwo

    defaults = {k: p.default for k, p in
                inspect.signature(bwo).parameters.items()
                if k != "use_kernel"}
    defaults["init_spread"] = \
        inspect.signature(init_population).parameters["spread"].default
    assert BWO == defaults
