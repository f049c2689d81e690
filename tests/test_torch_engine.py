"""The port's batched round engine against the reference's, on the CPU.

A toy logistic-regression task (conftest's ``make_toy_task``, its weights
carried across by ``convert.params_from_jax``) runs two rounds through
both packages' ``Server(engine="batched")`` under "vmap" and "scan":
FedBWO composed and on the kernel route (the reference's Pallas kernel in
interpret mode), FedAvg at C = 1 and C = 0.6, FedGWO; on IID and
Dirichlet (ragged, pad+mask) splits.  Each round: the same winner or
participants, scores within rtol 1e-4; the global parameters within rtol
1e-4, atol 1e-5; the ``CommMeter`` ledgers equal.  Then the narrow paper
CNN through ``build_experiment(engine="batched")``, the stacking and
engine-choice rules, and a vmapped round with vmap's per-example
fallback turned into an error.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import ClientHP as JClientHP, Server as JServer, Task as JTask  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.server import get_strategy as jget  # noqa: E402
from repro.data.loader import batch_dataset as jbatch  # noqa: E402
from repro.data.partition import (partition_dirichlet as jdirichlet,  # noqa: E402
                                  partition_iid as jiid)
from repro.data.synthetic import cnn_task as jcnn_task  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.client import ClientHP, Task  # noqa: E402
from repro_torch.core.engine import (make_batched_fedx_round,  # noqa: E402
                                     resolve_vectorize, stack_clients,
                                     task_uses_conv)
from repro_torch.core.server import Server, get_strategy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.loader import client_batches  # noqa: E402
from repro_torch.data.partition import partition_iid  # noqa: E402
from repro_torch.kernels.bwo_evolve import ref as bwo_ref  # noqa: E402
from repro_torch.metaheuristics import bwo  # noqa: E402

from conftest import make_toy_data, make_toy_task  # noqa: E402

N_CLIENTS = 5
CLASSES = 3
HP = dict(local_epochs=1, mh_pop=4, mh_generations=2, lr=0.05,
          fitness_batches=2)
NARROW = dict(conv1_filters=4, conv2_filters=8, dense_hidden=16)


def torch_toy_task(jtask, label: str) -> Task:
    """The reference's toy task in torch: init_params draws the reference's
    weights from the same key and carries them across."""
    def init_params(key):
        jkey = jnp.asarray(key.cpu().numpy().astype(np.uint32))
        return params_from_jax(jax.tree.map(np.asarray,
                                            jtask.init_params(jkey)),
                               key.device)

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        lp = F.log_softmax(logits, dim=-1)
        labels = batch[label]
        nll = -lp.gather(-1, labels[:, None].long()).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, acc

    return Task(init_params, loss_fn)


def labeled_toy_task():
    """conftest's toy task reading labels from "labels" (the key the
    Dirichlet partitioner splits on), as tests/test_ragged_engine.py's."""
    jtoy = make_toy_task()

    def loss_fn(params, batch):
        return jtoy.loss_fn(params, {"x": batch["x"], "y": batch["labels"]})
    return JTask(jtoy.init_params, loss_fn)


def to_torch(clients):
    return [params_from_jax(jax.tree.map(np.asarray, c), "cpu")
            for c in clients]


def iid_clients():
    data = make_toy_data(jax.random.PRNGKey(0), 400)
    return [jbatch(d, 8) for d in jiid(jax.random.PRNGKey(1), data,
                                       N_CLIENTS)]


def dirichlet_clients():
    raw = make_toy_data(jax.random.PRNGKey(0), 480, classes=CLASSES)
    parts = jdirichlet(jax.random.PRNGKey(5),
                       {"x": raw["x"], "labels": raw["y"]}, 4, alpha=0.5,
                       num_classes=CLASSES)
    return [jbatch(p, 8) for p in parts]


def run_pair(strategy, kernel, ratio, vectorize, split):
    """Two rounds of the batched engine in each package."""
    if split == "iid":
        jtask, label, jclients = make_toy_task(), "y", iid_clients()
    else:
        jtask, label, jclients = labeled_toy_task(), "labels", dirichlet_clients()
    jkw = {"use_pallas": True} if kernel else {}
    tkw = {"use_kernel": True} if kernel else {}
    jserver = JServer(jtask, jget(strategy, client_ratio=ratio, **jkw),
                      JClientHP(vectorize=vectorize, **HP), jclients,
                      jax.random.PRNGKey(3), engine="batched")
    tserver = Server(torch_toy_task(jtask, label),
                     get_strategy(strategy, client_ratio=ratio, **tkw),
                     ClientHP(vectorize=vectorize, **HP), to_torch(jclients),
                     R.PRNGKey(3, "cpu"), engine="batched")
    assert jserver.engine == tserver.engine == "batched"
    assert tserver._engine.vectorize == vectorize
    assert tserver._engine.padded == (split == "dirichlet")
    return ([jserver.run_round() for _ in range(2)], jserver,
            [tserver.run_round() for _ in range(2)], tserver)


def assert_same_run(jinfos, jserver, tinfos, tserver):
    for want, got in zip(jinfos, tinfos):
        assert got["engine"] == "batched"
        for k in ("best_client", "participants"):
            assert got.get(k) == want.get(k)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4)
    assert tserver.meter.summary() == jserver.meter.summary()
    assert tree.structure(tserver.global_params) == tree.structure(
        jax.tree.map(lambda _: None, jserver.global_params))
    for g, w in zip(tree.leaves(tserver.global_params),
                    jax.tree.leaves(jserver.global_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


STRATEGIES = {"fedbwo": ("fedbwo", False, 1.0),
              "fedbwo-kernel": ("fedbwo", True, 1.0),
              "fedavg": ("fedavg", False, 1.0),
              "fedavg-partial": ("fedavg", False, 0.6)}


@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
@pytest.mark.parametrize("case", list(STRATEGIES))
def test_batched_engine_matches_reference(case, vectorize):
    assert_same_run(*run_pair(*STRATEGIES[case], vectorize, "iid"))


@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
@pytest.mark.parametrize("case", list(STRATEGIES))
def test_dirichlet_pad_and_mask_matches_reference(case, vectorize):
    strategy, kernel, ratio = STRATEGIES[case]
    assert_same_run(*run_pair(strategy, kernel, 0.5 if ratio < 1 else 1.0,
                              vectorize, "dirichlet"))


@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
def test_fedgwo_through_the_batched_engine(vectorize):
    assert_same_run(*run_pair("fedgwo", False, 1.0, vectorize, "iid"))


@pytest.fixture(scope="module")
def cnn_reference():
    """The reference's batched engine on the narrow paper CNN (its CPU
    "auto" is scan), kernel route, two rounds."""
    settings = dict(n_clients=3, n_train=90, n_test=30, mh_pop=3,
                    mh_generations=1, local_epochs=1, max_rounds=2)
    cfg = japi.FLConfig(engine="batched", **settings)
    exp = japi.build_experiment(cfg, task=jcnn_task(JCNNConfig(**NARROW)))
    server = JServer(exp.server.task, jget("fedbwo", use_pallas=True),
                     cfg.client_hp(), exp.server.client_data,
                     jax.random.PRNGKey(cfg.server_seed), engine="batched")
    from repro.core.protocol import run_federated
    logs = run_federated(server, exp.eval_data, cfg.stop_conditions())
    return settings, logs, server


@pytest.mark.parametrize("vectorize", ["vmap", "scan"])
def test_narrow_cnn_batched_matches_reference(cnn_reference, vectorize):
    settings, want_logs, want_server = cnn_reference
    cfg = api.FLConfig(device="cpu", engine="batched", vectorize=vectorize,
                       bwo_kernel=True, **settings)
    result = api.build_experiment(cfg, task=synthetic.cnn_task(
        CNNConfig(**NARROW))).run()
    assert result.summary()["engine"] == "batched"
    assert len(result.logs) == len(want_logs) == 2
    for got, want in zip(result.logs, want_logs):
        assert got.info["best_client"] == want.info["best_client"]
        np.testing.assert_allclose(got.info["scores"], want.info["scores"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got.test_loss, want.test_loss, rtol=1e-4)
    assert result.server.meter.summary() == want_server.meter.summary()
    for g, w in zip(tree.leaves(result.server.global_params),
                    jax.tree.leaves(want_server.global_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------ stacking rules --
def toy_clients(sizes, d=8):
    return to_torch([jbatch(make_toy_data(jax.random.PRNGKey(i), n, d=d), 8)
                     for i, n in enumerate(sizes)])


def test_stack_clients_pads_and_masks_ragged_clients():
    clients = toy_clients([64, 96])                 # 8 and 12 batches
    assert stack_clients(clients) is None           # exact stacking only
    stacked, mask = stack_clients(clients, pad=True)
    assert tuple(stacked["x"].shape) == (2, 12, 8, 8)
    assert mask.shape == (2, 12) and int(mask.sum()) == 8 + 12
    assert mask[0, :8].all() and not mask[0, 8:].any() and mask[1].all()
    assert (stacked["x"][0, 8:] == 0).all()
    uniform, full = stack_clients(toy_clients([64, 64]), pad=True)
    assert bool(full.all()) and tuple(uniform["y"].shape) == (2, 8, 8)


def test_empty_shard_raises():
    clients = toy_clients([64, 64])
    clients[1] = tree.map(lambda a: a[:0], clients[1])
    with pytest.raises(ValueError, match="empty"):
        Server(torch_toy_task(make_toy_task(), "y"), get_strategy("fedbwo"),
               ClientHP(**HP), clients, R.PRNGKey(3, "cpu"),
               engine="batched")


def test_unstackable_clients_fall_back_under_auto_and_raise_when_batched():
    clients = toy_clients([64]) + toy_clients([64], d=16)[:1]
    assert stack_clients(clients) is None
    assert stack_clients(clients, pad=True) == (None, None)

    def server(engine):
        # the task reads only "x" and "y": the 8-wide client is the one
        # whose weights fit, which is all construction needs
        return Server(torch_toy_task(make_toy_task(), "y"),
                      get_strategy("fedbwo"), ClientHP(**HP), clients,
                      R.PRNGKey(3, "cpu"), engine=engine)
    assert server("auto").engine == "sequential"
    with pytest.raises(ValueError, match="not stackable"):
        server("batched")


def test_task_uses_conv_and_the_cpu_auto_policy():
    """cnn gives True and mlp False; on the CPU "auto" keeps the conv
    task sequential and batches the dense one, as the reference does."""
    train, _ = synthetic.make_cifar_like(R.PRNGKey(0, "cpu"), 40, 8)
    clients = client_batches(partition_iid(R.PRNGKey(1, "cpu"), train, 2), 10)
    sample = tree.map(lambda a: a[0], clients[0])
    conv, dense = synthetic.cnn_task(CNNConfig(**NARROW)), synthetic.mlp_task()
    assert task_uses_conv(conv, conv.init_params(R.PRNGKey(2, "cpu")), sample)
    assert not task_uses_conv(dense, dense.init_params(R.PRNGKey(2, "cpu")),
                              sample)
    assert task_uses_conv(dense, {}, sample)        # raising: conservative
    hp = ClientHP(local_epochs=1, mh_pop=2, mh_generations=1)
    for task, want in ((conv, "sequential"), (dense, "batched")):
        server = Server(task, get_strategy("fedbwo"), hp, clients,
                        R.PRNGKey(3, "cpu"), engine="auto")
        assert server.engine == want


def test_resolve_vectorize_by_device():
    assert resolve_vectorize("auto", "cpu") == "scan"
    assert resolve_vectorize("auto", torch.device("cuda")) == "vmap"
    assert resolve_vectorize("auto", "cuda:0") == "vmap"
    assert resolve_vectorize("unroll", "cpu") == "unroll"
    assert resolve_vectorize("scan:4", "cuda") == "scan"
    assert resolve_vectorize("vmap", "cpu") == "vmap"
    with pytest.raises(ValueError):
        resolve_vectorize("bogus", "cpu")


@pytest.mark.parametrize("vectorize", ["scan", "unroll", "scan:2"])
def test_loop_modes_match_vmap(vectorize):
    """Every loop spelling runs the same loop, and agrees with vmap."""
    task = torch_toy_task(make_toy_task(), "y")
    stacked = stack_clients(to_torch(iid_clients()))
    params = task.init_params(R.PRNGKey(9, "cpu"))
    keys = R.split(R.PRNGKey(3, "cpu"), N_CLIENTS)
    hp = ClientHP(**HP)
    out = {m: make_batched_fedx_round(task, hp, bwo(), "cpu", vectorize=m)(
        params, stacked, None, keys) for m in ("vmap", vectorize)}
    (wv, sv, bv), (wl, sl, bl) = out["vmap"], out[vectorize]
    assert int(bv) == int(bl) == int(torch.argmin(sl))
    torch.testing.assert_close(sl, sv, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree.leaves(wl), tree.leaves(wv)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strategy,kernel", [("fedbwo", True),
                                             ("fedbwo", False),
                                             ("fedavg", False)])
def test_vmapped_round_takes_no_fallback(monkeypatch, strategy, kernel):
    """A vmapped round of the narrow CNN on a Dirichlet (masked) split
    with vmap's per-example fallback warning raised as an error: every
    op has a batching rule, and the kernel route's generation reaches the
    update once for all clients' rows."""
    rows = []
    plain = bwo_ref.bwo_evolve_ref
    monkeypatch.setattr(bwo_ref, "bwo_evolve_ref", lambda pop, *a, **kw: (
        rows.append(pop.shape[0]), plain(pop, *a, **kw))[1])
    cfg = api.FLConfig(device="cpu", engine="batched", vectorize="vmap",
                       strategy=strategy, bwo_kernel=kernel,
                       partition="dirichlet", n_clients=3, n_train=120,
                       n_test=10, mh_pop=3, mh_generations=2,
                       local_epochs=1, max_rounds=1)
    exp = api.build_experiment(
        cfg, task=synthetic.cnn_task(CNNConfig(**NARROW)))
    assert exp.server._engine.padded
    set_warning = torch._C._functorch._set_vmap_fallback_warning_enabled
    set_warning(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            # the positive control: an op with no batching rule raises
            with pytest.raises(UserWarning, match="batching rule"):
                torch.func.vmap(torch.histc)(torch.ones(2, 3))
            info = exp.server.run_round()
    finally:
        set_warning(False)
    assert info["engine"] == "batched"
    assert rows == ([3 * 3] * 2 if kernel else [])
