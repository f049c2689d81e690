"""BWO in the port against the reference: ``init_population`` and one
step of each route (composed, and kernel — the reference's Pallas kernel
in interpret mode) with a toy fitness, within 1e-5; selection on ties."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.metaheuristics import REGISTRY as JREGISTRY, base as jbase  # noqa: E402
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
    assert set(REGISTRY) == set(JREGISTRY) == {"bwo", "pso", "gwo", "sca",
                                               "avo"}
    from repro.core.api import strategy_names as jstrategy_names
    from repro_torch.core.api import strategy_names
    assert strategy_names() == jstrategy_names()


def _close_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "t":
            assert int(got[k]) == int(want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)


@pytest.mark.parametrize("name", ["pso", "gwo", "sca", "avo"])
@pytest.mark.parametrize("P,D", [(6, 300), (4, 129), (2, 50), (1, 20)])
def test_other_metaheuristics_match_reference(name, P, D):
    """Init and four generations under the same keys: every state entry
    (PSO's velocities and bests too) within 1e-5.  Populations of 2 and 1
    are fewer than GWO's three leaders and AVO's two, which the
    reference's clamped indexing repeats."""
    jfit, tfit = _fitness(D, seed=D + len(name))
    x0 = np.random.default_rng(3).normal(size=D).astype(np.float32)
    jk0, jk1 = jax.random.split(jax.random.PRNGKey(P + D))
    jmh, tmh = JREGISTRY[name](), REGISTRY[name]()
    jstate = jmh.init(jk0, jnp.asarray(x0), P, jfit)
    tstate = tmh.init(tkey(jk0), torch.as_tensor(x0), P, tfit)
    _close_tree(tstate, jstate)
    for k in jax.random.split(jk1, 4):
        jstate = jmh.step(k, jstate, jfit)
        tstate = tmh.step(tkey(k), tstate, tfit)
        _close_tree(tstate, jstate)


@pytest.mark.parametrize("name", ["bwo", "bwo-kernel", "pso", "gwo", "sca",
                                  "avo"])
def test_steps_under_vmap_match_a_loop(name):
    """Each client's own ``worst``, ``order`` and keys: a vmapped step over
    three clients equals three single steps, bit for bit."""
    P, D, C = 5, 64, 3
    mh = (bwo(use_kernel=True) if name == "bwo-kernel"
          else REGISTRY[name]())
    target = torch.as_tensor(
        np.random.default_rng(4).normal(size=(C, D)).astype(np.float32))
    x0 = torch.as_tensor(
        np.random.default_rng(5).normal(size=(C, D)).astype(np.float32))
    keys = R.split(R.PRNGKey(11, "cpu"), C)

    def run(x, tgt, key):
        def fit(p):
            return torch.sum((p - tgt) ** 2, dim=1)
        k0, k1 = R.split(key)
        state = mh.init(k0, x, P, fit)
        for k in R.split(k1, 2):
            state = mh.step(k, state, fit)
        return base.best_member(state)

    got = torch.func.vmap(run)(x0, target, keys)
    for c in range(C):
        want = run(x0[c], target[c], keys[c])
        assert all(torch.equal(g[c], w) for g, w in zip(got, want))
