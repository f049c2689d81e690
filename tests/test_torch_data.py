"""The port's synthetic data, partitions and batching against the
reference under the same seeds: labels and splits exactly, images within
1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.data import loader as jloader, partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import loader, partition, synthetic  # noqa: E402


@pytest.fixture(scope="module")
def datasets():
    want = jsyn.make_cifar_like(jax.random.PRNGKey(42), 200, 60)
    got = synthetic.make_cifar_like(R.PRNGKey(42, "cpu"), 200, 60)
    return want, got


def test_make_cifar_like(datasets):
    want, got = datasets
    for w, g in zip(want, got):
        assert g["images"].dtype == torch.float32
        assert g["labels"].dtype == torch.int32
        assert tuple(g["images"].shape) == w["images"].shape
        assert (g["labels"].numpy() == np.asarray(w["labels"])).all()
        np.testing.assert_allclose(g["images"].numpy(),
                                   np.asarray(w["images"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_clients", [3, 10])
def test_partition_iid(datasets, n_clients):
    (jtrain, _), (ttrain, _) = datasets
    want = jpart.partition_iid(jax.random.PRNGKey(1), jtrain, n_clients)
    got = partition.partition_iid(R.PRNGKey(1, "cpu"), ttrain, n_clients)
    assert len(got) == len(want) == n_clients
    for w, g in zip(want, got):
        assert (g["labels"].numpy() == np.asarray(w["labels"])).all()
        np.testing.assert_allclose(g["images"].numpy(),
                                   np.asarray(w["images"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.5, 5.0])
def test_partition_dirichlet(datasets, alpha):
    (jtrain, _), (ttrain, _) = datasets
    want = jpart.partition_dirichlet(jax.random.PRNGKey(3), jtrain, 4,
                                     alpha=alpha)
    got = partition.partition_dirichlet(R.PRNGKey(3, "cpu"), ttrain, 4,
                                        alpha=alpha)
    assert [len(g["labels"]) for g in got] == [len(w["labels"]) for w in want]
    for w, g in zip(want, got):
        assert (g["labels"].numpy() == np.asarray(w["labels"])).all()


def test_client_batches(datasets):
    (jtrain, _), (ttrain, _) = datasets
    jparts = jpart.partition_iid(jax.random.PRNGKey(1), jtrain, 3)
    tparts = partition.partition_iid(R.PRNGKey(1, "cpu"), ttrain, 3)
    want = jloader.client_batches(jparts, 10)
    got = loader.client_batches(tparts, 10)
    for w, g in zip(want, got):
        assert tuple(g["images"].shape) == w["images"].shape == (6, 10, 32, 32, 3)
        assert (g["labels"].numpy() == np.asarray(w["labels"])).all()


@pytest.mark.parametrize("which", ["cnn", "mlp"])
def test_tasks(datasets, which):
    (jtrain, _), (ttrain, _) = datasets
    jtask = jsyn.cnn_task() if which == "cnn" else jsyn.mlp_task()
    ttask = synthetic.cnn_task() if which == "cnn" else synthetic.mlp_task()
    jp = jtask.init_params(jax.random.PRNGKey(5))
    tp = ttask.init_params(R.PRNGKey(5, "cpu"))
    for g, w in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb = {k: v[:8] for k, v in jtrain.items()}
    tb = {k: v[:8] for k, v in ttrain.items()}
    jl, jacc = jtask.loss_fn(jp, jb)
    tl, tacc = ttask.loss_fn(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    assert float(tacc) == float(jacc)
