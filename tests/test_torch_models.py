"""The port's CNN pieces against the reference: modules, init, forward,
loss, accuracy and gradients (with and without dropout), and the flat
genome's order.  Weights are carried across with ``params_from_jax``;
tolerance 1e-5 (float32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs.paper_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models import cnn as jcnn, modules as jmod  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.convert import (params_from_jax, params_to_numpy,  # noqa: E402
                                 ravel_params)
from repro_torch.models import cnn, modules  # noqa: E402

NARROW = dict(conv1_filters=4, conv2_filters=8, dense_hidden=16)
TOL = dict(rtol=1e-5, atol=1e-5)


def tkey(jkey):
    return R.as_key(np.asarray(jkey), "cpu")


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(kw or TOL))


def _batch(seed=0, b=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(b,)).astype(np.int32))


def test_config_is_the_reference_config():
    assert CNNConfig() == CNNConfig(**{
        f: getattr(JCNNConfig(), f) for f in JCNNConfig.__dataclass_fields__})


@pytest.mark.parametrize("k,h", [(5, 32), (3, 16), (5, 7)])
def test_conv2d_same_padding_and_valid_maxpool(k, h):
    jk = jax.random.PRNGKey(k * 100 + h)
    p = jmod.conv2d_init(jk, k, k, 3, 4)
    p = {"w": p["w"], "b": jax.random.normal(jk, (4,))}
    x = np.random.default_rng(0).normal(size=(2, h, h, 3)).astype(np.float32)
    want = jmod.conv2d_apply(p, jnp.asarray(x))
    got = modules.conv2d_apply(params_from_jax(p, "cpu"), torch.as_tensor(x))
    assert tuple(got.shape) == want.shape == (2, h, h, 4)
    close(got, want)
    # VALID pooling drops an odd trailing row and column
    close(modules.maxpool2(got), jmod.maxpool2(want))


def test_init_matches_reference():
    jk = jax.random.PRNGKey(5)
    want = jcnn.cnn_init(jk, JCNNConfig(**NARROW))
    got = cnn.cnn_init(tkey(jk), CNNConfig(**NARROW))
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)
    d = modules.dense_init(tkey(jk), 7, 3, bias=True, dtype=torch.float32)
    dj = jmod.dense_init(jk, 7, 3, bias=True, dtype=jnp.float32)
    close(modules.dense_apply(d, torch.ones(2, 7)),
          jmod.dense_apply(dj, jnp.ones((2, 7))))


@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "paper"])
def test_ravel_order_matches_ravel_pytree(cfg_kw):
    jp = jcnn.cnn_init(jax.random.PRNGKey(1), JCNNConfig(**cfg_kw))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jflat, junravel = ravel_pytree(jp)
    flat, unravel = ravel_params(tp)
    assert flat.shape == jflat.shape
    assert (flat.numpy() == np.asarray(jflat)).all()
    back = params_to_numpy(unravel(flat * 2))
    jback = junravel(jflat * 2)
    for g, w in zip(tree.leaves(back), jax.tree.leaves(jback)):
        assert (g == np.asarray(w)).all()
    if not cfg_kw:   # the paper CNN at its published widths
        assert flat.numel() == 2_465_322


@pytest.mark.parametrize("dropout_seed", [None, 3])
def test_forward_loss_acc_grads(dropout_seed):
    jp = jcnn.cnn_init(jax.random.PRNGKey(2), JCNNConfig(**NARROW))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x, y = _batch()
    jdk = None if dropout_seed is None else jax.random.PRNGKey(dropout_seed)
    tdk = None if jdk is None else tkey(jdk)
    train = jdk is not None

    jlogits = jcnn.cnn_apply(jp, jnp.asarray(x), train=train, dropout_rng=jdk)
    tlogits = cnn.cnn_apply(tp, torch.as_tensor(x), train=train,
                            dropout_rng=tdk)
    close(tlogits, jlogits)

    def jloss(p):
        return jcnn.cnn_loss(p, jnp.asarray(x), jnp.asarray(y), train=train,
                             dropout_rng=jdk)

    (jl, jacc), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [l.requires_grad_(True) for l in tree.leaves(tp)]
    tl, tacc = cnn.cnn_loss(tp, torch.as_tensor(x), torch.as_tensor(y),
                            train=train, dropout_rng=tdk)
    grads = torch.autograd.grad(tl, leaves)
    close(tl, jl)
    assert float(tacc) == float(jacc)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        close(g, w)


def test_dropout_mask_is_the_reference_mask():
    """Dropout keeps fc1 units by bernoulli(key, 0.8, (B, 512)); zeroed
    units match, so the logits differ from the eval forward where the
    reference's do."""
    jp = jcnn.cnn_init(jax.random.PRNGKey(4), JCNNConfig())
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x, _ = _batch(1, b=3)
    jk = jax.random.PRNGKey(9)
    want = jcnn.cnn_apply(jp, jnp.asarray(x), train=True, dropout_rng=jk)
    got = cnn.cnn_apply(tp, torch.as_tensor(x), train=True,
                        dropout_rng=tkey(jk))
    assert got.shape == (3, 10)
    close(got, want)
