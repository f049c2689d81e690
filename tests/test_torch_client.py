"""One client update of the port against the reference's, on a narrow
paper CNN under the same key: score and params within 1e-4 (SGD steps and
BWO generations compound float32 rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.data import loader as jloader, synthetic as jsyn  # noqa: E402
from repro.metaheuristics.bwo import bwo as jbwo  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import client  # noqa: E402
from repro_torch.data import loader, synthetic  # noqa: E402
from repro_torch.metaheuristics.bwo import bwo  # noqa: E402

NARROW = dict(conv1_filters=4, conv2_filters=8, dense_hidden=16)
TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    "fedbwo": dict(mh="bwo"),
    "fedbwo-kernel": dict(mh="bwo-kernel"),
    "fedavg": dict(mh=None),
    "fedprox": dict(mh=None, prox_mu=0.1),
    "subspace": dict(mh="bwo", subspace=True),
    "one-batch": dict(mh="bwo", n=10),
}


@pytest.fixture(scope="module")
def world():
    jtrain, _ = jsyn.make_cifar_like(jax.random.PRNGKey(0), 40, 10)
    ttrain, _ = synthetic.make_cifar_like(R.PRNGKey(0, "cpu"), 40, 10)
    jtask, ttask = (jsyn.cnn_task(JCNNConfig(**NARROW)),
                    synthetic.cnn_task(CNNConfig(**NARROW)))
    jparams = jtask.init_params(jax.random.PRNGKey(1))
    return jtrain, ttrain, jtask, ttask, jparams


@pytest.mark.parametrize("case", list(CASES))
def test_client_update_matches_reference(world, case):
    jtrain, ttrain, jtask, ttask, jparams = world
    spec = dict(CASES[case])
    n, mh = spec.pop("n", 40), spec.pop("mh")
    hp_kw = dict(local_epochs=2, mh_pop=3, mh_generations=2, **spec)
    jmh = None if mh is None else jbwo(use_pallas=mh.endswith("kernel"))
    tmh = None if mh is None else bwo(use_kernel=mh.endswith("kernel"))
    jdata = jloader.batch_dataset({k: v[:n] for k, v in jtrain.items()}, 10)
    tdata = loader.batch_dataset({k: v[:n] for k, v in ttrain.items()}, 10)
    jupdate = jax.jit(jclient.make_client_update(
        jtask, jclient.ClientHP(**hp_kw), jmh))
    tupdate = client.make_client_update(ttask, client.ClientHP(**hp_kw), tmh)
    jk = jax.random.PRNGKey(5)
    jscore, jout = jupdate(jparams, jdata, jk)
    tscore, tout = tupdate(params_from_jax(jax.tree.map(np.asarray, jparams),
                                           "cpu"), tdata,
                           R.as_key(np.asarray(jk), "cpu"))
    np.testing.assert_allclose(float(tscore), float(jscore), **TOL)
    assert tree.structure(tout) == tree.structure(
        jax.tree.map(lambda _: None, jout))
    for g, w in zip(tree.leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kernel", [False, True], ids=["composed", "kernel"])
def test_masked_update_belongs_to_the_batched_engine(world, kernel):
    """The masked update (a client's row of a pad+mask stack) against the
    reference's: three valid batches padded to five, fewer valid batches
    than fitness batches' worth of distinct ones.  Padded batches take no
    SGD step, hold the key carry, and are never scored."""
    jtrain, ttrain, jtask, ttask, jparams = world
    hp_kw = dict(local_epochs=2, mh_pop=3, mh_generations=2,
                 fitness_batches=4)
    jdata = jloader.batch_dataset({k: v[:30] for k, v in jtrain.items()}, 10)
    tdata = loader.batch_dataset({k: v[:30] for k, v in ttrain.items()}, 10)
    jpad = jax.tree.map(lambda a: np.concatenate(
        [np.asarray(a), np.zeros((2,) + a.shape[1:], a.dtype)]), jdata)
    tpad = tree.map(lambda a: torch.cat([a, a.new_zeros((2, *a.shape[1:]))]),
                    tdata)
    mask = np.arange(5) < 3
    jupdate = jax.jit(jclient.make_client_update(
        jtask, jclient.ClientHP(**hp_kw), jbwo(use_pallas=kernel),
        masked=True))
    tupdate = client.make_client_update(
        ttask, client.ClientHP(**hp_kw), bwo(use_kernel=kernel), masked=True)
    jk = jax.random.PRNGKey(6)
    jscore, jout = jupdate(jparams, jpad, mask, jk)
    tscore, tout = tupdate(params_from_jax(jax.tree.map(np.asarray, jparams),
                                           "cpu"), tpad, torch.as_tensor(mask),
                           R.as_key(np.asarray(jk), "cpu"))
    np.testing.assert_allclose(float(tscore), float(jscore), **TOL)
    for g, w in zip(tree.leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # and the same client unpadded, in the port
    uscore, uout = client.make_client_update(
        ttask, client.ClientHP(**hp_kw), bwo(use_kernel=kernel))(
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), tdata,
        R.as_key(np.asarray(jk), "cpu"))
    assert float(uscore) == float(tscore)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(uout),
                                                 tree.leaves(tout)))
