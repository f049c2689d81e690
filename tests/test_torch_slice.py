"""The port's main path as a whole against the reference, on the CPU:
``build_experiment(cfg).run()`` with a narrow paper CNN, 3 clients,
n_train=90, n_test=30, pop 3, 1 generation, 1 local epoch, 2 rounds.

(a) the default composed FedBWO, (b) the kernel route (the reference
reaches its Pallas kernel, in interpret mode, through
``get_strategy("fedbwo", use_pallas=True)``), (c) FedAvg with C = 1.
Each round: the same winner (or participants), scores and test loss
within 1e-4, and the CommMeter ledger equal.  FedAvg with C < 1 (2 of 3
clients, drawn by ``choice`` without replacement) is a fourth case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.protocol import run_federated as jrun_federated  # noqa: E402
from repro.core.server import Server as JServer, get_strategy as jget  # noqa: E402
from repro.data.synthetic import cnn_task as jcnn_task  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.server import Server  # noqa: E402
from repro_torch.data.synthetic import cnn_task  # noqa: E402
from repro_torch.kernels.bwo_evolve import bwo_evolve as kernel_mod  # noqa: E402

NARROW = dict(conv1_filters=4, conv2_filters=8, dense_hidden=16)
SETTINGS = dict(n_clients=3, n_train=90, n_test=30, mh_pop=3,
                mh_generations=1, local_epochs=1, max_rounds=2)


def _reference(strategy, kernel, ratio):
    cfg = japi.FLConfig(strategy=strategy, engine="sequential",
                        client_ratio=ratio, **SETTINGS)
    exp = japi.build_experiment(cfg, task=jcnn_task(JCNNConfig(**NARROW)))
    if not kernel:
        return exp.run().logs, exp.server.meter
    server = JServer(exp.server.task, jget("fedbwo", use_pallas=True),
                     cfg.client_hp(), exp.server.client_data,
                     jax.random.PRNGKey(cfg.server_seed), engine="sequential")
    logs = jrun_federated(server, exp.eval_data, cfg.stop_conditions())
    return logs, server.meter


@pytest.mark.parametrize("strategy,kernel,ratio", [
    ("fedbwo", False, 1.0), ("fedbwo", True, 1.0), ("fedavg", False, 1.0),
    ("fedavg", False, 0.67)],
    ids=["fedbwo-composed", "fedbwo-kernel", "fedavg", "fedavg-partial"])
def test_slice_matches_reference(strategy, kernel, ratio):
    want_logs, want_meter = _reference(strategy, kernel, ratio)
    cfg = api.FLConfig(strategy=strategy, device="cpu", bwo_kernel=kernel,
                       client_ratio=ratio, **SETTINGS)
    result = api.build_experiment(cfg, task=cnn_task(CNNConfig(**NARROW))).run()
    assert len(result.logs) == len(want_logs) == 2
    for got, want in zip(result.logs, want_logs):
        assert got.round == want.round
        for k in ("best_client", "participants"):
            assert got.info.get(k) == want.info.get(k)
        np.testing.assert_allclose(got.info["scores"], want.info["scores"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.test_loss, want.test_loss,
                                   rtol=1e-4, atol=1e-4)
        assert abs(got.test_acc - want.test_acc) <= 1.0 / SETTINGS["n_test"]
    assert result.server.meter.summary() == want_meter.summary()
    summary = result.summary()
    assert summary["engine"] == "sequential" and summary["rounds"] == 2
    assert summary["comm"]["model_bytes"] == want_meter.model_bytes


def test_full_width_model_bytes_match_the_reference():
    """model_bytes comes from the leaves: 2,465,322 float32 parameters."""
    cfg = api.FLConfig(device="cpu", n_clients=2, n_train=20, n_test=10)
    exp = api.build_experiment(cfg)
    assert exp.meter.model_bytes == 9_861_288
    assert kernel_mod.launches == 0


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build_experiment(api.FLConfig(n_clients=2, n_train=20, n_test=10))


def test_not_yet_ported_options_raise():
    """No option is left unported: the auditor runs and reports, the
    batched engine, fused rounds on it and every FedX strategy build, and
    an unknown strategy is refused."""
    cfg = api.FLConfig(device="cpu", task="mlp", n_clients=2, n_train=20,
                       n_test=10, mh_pop=2, mh_generations=1, local_epochs=1)
    assert api.build_experiment(cfg, audit="report").audit_report.ok
    fused = api.build_experiment(api.FLConfig(
        device="cpu", engine="batched", rounds_per_dispatch=5,
        n_clients=2, n_train=20, n_test=10)).server
    assert (fused.engine, fused.rounds_per_dispatch) == ("batched", 5)
    exp = api.build_experiment(api.FLConfig(
        device="cpu", engine="batched", strategy="fedpso", n_clients=2,
        n_train=20, n_test=10))
    assert exp.server.engine == "batched"
    with pytest.raises(ValueError):
        api.FLConfig(strategy="fedfoo")


@pytest.mark.parametrize("rpd,pipe,want", [(1, "auto", (1, False)),
                                           ("auto", "auto", (1, False)),
                                           (5, "on", (5, True)),
                                           (3, "off", (3, False))])
def test_sequential_engine_resolves_knobs_as_the_reference(rpd, pipe, want):
    cfg = api.FLConfig(device="cpu", task="mlp", n_clients=2, n_train=20,
                       n_test=10, engine="sequential",
                       rounds_per_dispatch=rpd, pipeline_blocks=pipe)
    server = api.build_experiment(cfg).server
    jcfg = japi.FLConfig(task="mlp", n_clients=2, n_train=20, n_test=10,
                         engine="sequential", rounds_per_dispatch=rpd,
                         pipeline_blocks=pipe)
    jserver = japi.build_experiment(jcfg).server
    assert isinstance(server, Server) and server.engine == "sequential"
    got = (server.rounds_per_dispatch, server.pipeline_blocks)
    assert got == (jserver.rounds_per_dispatch, jserver.pipeline_blocks) == want


@pytest.mark.parametrize("rpd,pipe,want", [(1, "auto", (1, False)),
                                           ("auto", "auto", (5, True)),
                                           (5, "auto", (5, True)),
                                           (2, "on", (2, True)),
                                           (3, "off", (3, False))])
def test_batched_engine_resolves_knobs_until_fused_rounds_land(rpd, pipe,
                                                               want):
    """Fused rounds have landed: on the batched engine "auto" is 5 rounds
    a dispatch, pipelined, and a forced R > 1 runs, as in the
    reference."""
    cfg = api.FLConfig(device="cpu", task="mlp", n_clients=2, n_train=20,
                       n_test=10, rounds_per_dispatch=rpd,
                       pipeline_blocks=pipe)
    server = api.build_experiment(cfg).server
    jserver = japi.build_experiment(japi.FLConfig(
        task="mlp", n_clients=2, n_train=20, n_test=10,
        rounds_per_dispatch=rpd, pipeline_blocks=pipe)).server
    assert server.engine == jserver.engine == "batched"
    got = (server.rounds_per_dispatch, server.pipeline_blocks)
    assert got == (jserver.rounds_per_dispatch, jserver.pipeline_blocks) == want


def test_fl_train_cli(monkeypatch, capsys):
    from repro_torch.launch import fl_train
    monkeypatch.setattr("sys.argv", [
        "fl_train", "--device", "cpu", "--task", "mlp", "--clients", "2",
        "--rounds", "1", "--train", "20", "--test", "10", "--pop", "2",
        "--generations", "1", "--local-epochs", "1", "--bwo-kernel"])
    fl_train.main()
    out = capsys.readouterr().out
    # a dense task batches on the CPU, as the reference's CLI does
    assert "engine=batched device=cpu bwo_kernel=True" in out
    assert "rounds_per_dispatch=1 pipeline_blocks=False" in out
    assert '"engine": "batched"' in out
    assert '"uplink_bytes"' in out and '"rounds": 1' in out
