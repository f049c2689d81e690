import jax
import jax.numpy as jnp
import pytest

from repro.core.client import Task


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def make_toy_task(d: int = 8, classes: int = 3) -> Task:
    """Fast logistic-regression task for FL behaviour tests."""
    def init_params(rng):
        k1, _ = jax.random.split(rng)
        return {"w": jax.random.normal(k1, (d, classes)) * 0.1,
                "b": jnp.zeros((classes,))}

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, batch["y"][:, None], -1).mean()
        acc = (logits.argmax(-1) == batch["y"]).mean()
        return nll, acc

    return Task(init_params, loss_fn)


def make_toy_data(rng, n: int, d: int = 8, classes: int = 3,
                  w_seed: int = 123):
    """Linearly separable synthetic classification data.  The labelling
    weights come from ``w_seed`` (not ``rng``) so separately drawn
    train/test splits share the same ground truth."""
    w_true = jax.random.normal(jax.random.PRNGKey(w_seed), (d, classes))
    x = jax.random.normal(rng, (n, d))
    y = (x @ w_true).argmax(-1).astype(jnp.int32)
    return {"x": x, "y": y}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU "
        "mode); skips where torch sees no CUDA device")
