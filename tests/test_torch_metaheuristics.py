"""BWO in the port against the reference: ``init_population`` and one
step of each route (composed, and kernel — the reference's Pallas kernel
in interpret mode) with a toy fitness, within 1e-5; selection on ties."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.metaheuristics import base as jbase  # noqa: E402
from repro.metaheuristics.bwo import bwo as jbwo  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.metaheuristics import REGISTRY, base  # noqa: E402
from repro_torch.metaheuristics.bwo import bwo  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def tkey(jkey):
    return R.as_key(np.asarray(jkey), "cpu")


def _fitness(D, seed=0):
    target = np.random.default_rng(seed).normal(size=D).astype(np.float32)
    jt, tt = jnp.asarray(target), torch.as_tensor(target)
    return (lambda p: jnp.sum((p - jt) ** 2, axis=1),
            lambda p: torch.sum((p - tt) ** 2, dim=1))


def _state_close(got, want):
    np.testing.assert_allclose(got["pop"].numpy(), np.asarray(want["pop"]), **TOL)
    np.testing.assert_allclose(got["fit"].numpy(), np.asarray(want["fit"]), **TOL)
    assert int(got["t"]) == int(want["t"])


@pytest.mark.parametrize("P,D", [(6, 50), (3, 1000)])
def test_init_population(P, D):
    jfit, tfit = _fitness(D)
    x0 = np.random.default_rng(1).normal(size=D).astype(np.float32)
    jk = jax.random.PRNGKey(P + D)
    want = jbase.init_population(jk, jnp.asarray(x0), P, jfit)
    got = base.init_population(tkey(jk), torch.as_tensor(x0), P, tfit)
    assert (got["pop"][0].numpy() == x0).all()
    _state_close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["composed", "kernel"])
@pytest.mark.parametrize("P,D", [(6, 300), (4, 129), (3, 1000)])
def test_one_step_of_each_route(use_kernel, P, D):
    """The routes draw differently (a 6-way split of the generation key
    for the composed step, 5-way inside bwo_evolve for the kernel step):
    each is held against its own reference route."""
    jfit, tfit = _fitness(D, seed=D)
    x0 = np.random.default_rng(2).normal(size=D).astype(np.float32)
    jk0, jk1 = jax.random.split(jax.random.PRNGKey(P * D))
    jmh, tmh = jbwo(use_pallas=use_kernel), bwo(use_kernel=use_kernel)
    jstate = jmh.init(jk0, jnp.asarray(x0), P, jfit)
    tstate = tmh.init(tkey(jk0), torch.as_tensor(x0), P, tfit)
    for k in jax.random.split(jk1, 2):           # two generations
        jstate = jmh.step(k, jstate, jfit)
        tstate = tmh.step(tkey(k), tstate, tfit)
        _state_close(tstate, jstate)
    jbest, jbest_fit = jbase.best_member(jstate)
    tbest, tbest_fit = base.best_member(tstate)
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), **TOL)
    np.testing.assert_allclose(float(tbest_fit), float(jbest_fit), rtol=1e-5)


def test_selection_is_stable_on_ties():
    """jnp.argsort is stable: tied fitness keeps population order, and
    the first minimum wins."""
    fit = np.array([2.0, 1.0, 3.0, 1.0, 1.0, 0.5, 0.5], np.float32)
    pop = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    for n in (1, 3, 5, 7):
        wp, wf = jbase.select_best(jnp.asarray(pop), jnp.asarray(fit), n)
        gp, gf = base.select_best(torch.as_tensor(pop), torch.as_tensor(fit), n)
        assert (gp.numpy() == np.asarray(wp)).all()
        assert (gf.numpy() == np.asarray(wf)).all()
    state = {"pop": pop, "fit": fit}
    wb, _ = jbase.best_member({k: jnp.asarray(v) for k, v in state.items()})
    gb, _ = base.best_member({k: torch.as_tensor(v) for k, v in state.items()})
    assert (gb.numpy() == np.asarray(wb)).all()


def test_registry_holds_the_ported_metaheuristics():
    assert set(REGISTRY) == {"bwo"}
