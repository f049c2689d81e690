"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same numpy inputs: float32 arithmetic
in the same order, so each value within 1e-6 relative (XLA and torch may
round a fused product or a sum in another order by an ulp), and the
in-place update the train step uses equal, bit for bit, to the
reference-style ``update`` + ``apply_updates``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim, tree  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402

RTOL = 1e-6
STEPS = [0, 1, 5, 9, 10, 11, 37, 99, 100, 101, 500, 5000, 20000]


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=0)


SCHEDULES = [("constant", (3e-4,)), ("cosine_decay", (1e-3, 1000)),
             ("cosine_decay", (2e-4, 50, 0.0)),
             ("warmup_cosine", (3e-4, 100, 10_000)),
             ("warmup_cosine", (1e-2, 10, 50)), ("warmup_cosine", (5e-4, 0, 7))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_the_reference(name, args):
    jfn, tfn = getattr(jopt, name)(*args), getattr(optim, name)(*args)
    for step in STEPS:
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        close(got, jfn(jnp.int32(step)))
    # a Python int step gives the same rate
    assert float(tfn(7)) == float(tfn(torch.tensor(7)))


def _tree(rng, dtype):
    """A small parameter tree with bf16 or f32 leaves and a scalar."""
    def a(*shape):
        return rng.normal(size=shape).astype(dtype)
    return {"dense": {"b": a(5), "w": a(4, 5)}, "embed": {"table": a(7, 3)},
            "scale": a()}


OPTIMIZERS = [("sgd", dict(lr=0.1)), ("sgd", dict(lr=0.05, momentum=0.9)),
              ("adamw", dict(lr=1e-2)),
              ("adamw", dict(lr=3e-3, weight_decay=0.1)),
              ("adamw", dict(lr="warmup_cosine", weight_decay=0.01))]


def _opts(name, kw):
    kw = dict(kw)
    if kw["lr"] == "warmup_cosine":
        return (getattr(jopt, name)(**dict(kw, lr=jopt.warmup_cosine(1e-2, 2, 6))),
                getattr(optim, name)(**dict(kw, lr=optim.warmup_cosine(1e-2, 2, 6))))
    return getattr(jopt, name)(**kw), getattr(optim, name)(**kw)


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizers_match_the_reference(name, kw, dtype):
    """Five steps of random gradients (in the parameters' type): the
    updates, the moments (float32 whatever the type) and the parameters
    after ``apply_updates``."""
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(3)
    jo, to = _opts(name, kw)
    params = _tree(rng, np_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for m in tree.leaves(ts):
        assert m.dtype == torch.float32
    for step in range(5):
        grads = _tree(rng, np_dtype)
        jg = jax.tree.map(jnp.asarray, grads)
        tg = params_from_jax(grads, "cpu")
        ju, js = jo.update(jg, js, jp, jnp.int32(step))
        tu, ts = to.update(tg, ts, tp, torch.tensor(step, dtype=torch.int32))
        jp = jopt.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
        for got, want in ((tu, ju), (ts, js)):
            for g, w in zip(tree.leaves(params_to_numpy(got)),
                            jax.tree.leaves(want)):
                close(g, w)
        for g, w in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert g.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[dtype]
            close(g.float(), np.asarray(w, np.float32))


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_in_place_update_equals_update_and_apply(name, kw):
    """``update_`` (the train step's) changes the parameters and the
    moments in place to exactly what ``update`` + ``apply_updates`` give,
    and leaves ``update``'s own inputs untouched."""
    _, to = _opts(name, kw)
    rng = np.random.default_rng(5)
    for np_dtype in (np.float32, ml_dtypes.bfloat16):
        tp = params_from_jax(_tree(rng, np_dtype), "cpu")
        ts = to.init(tp)
        for step in range(4):
            tg = params_from_jax(_tree(rng, np_dtype), "cpu")
            snapshot = tree.map(torch.clone, (tp, ts)[1])
            upd, new_state = to.update(tg, ts, tp, torch.tensor(step))
            for a, b in zip(tree.leaves(ts), tree.leaves(snapshot)):
                assert torch.equal(a, b)
            want = optim.apply_updates(tp, upd)
            leaves = tree.leaves(tp)
            to.update_(tp, tg, ts, torch.tensor(step))
            assert all(a is b for a, b in zip(tree.leaves(tp), leaves))
            for a, b in zip(tree.leaves(tp), tree.leaves(want)):
                assert torch.equal(a, b)
            for a, b in zip(tree.leaves(ts), tree.leaves(new_state)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(dtype, max_norm):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    grads = _tree(np.random.default_rng(7), np_dtype)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    tg = params_from_jax(grads, "cpu")
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    close(tn, jn)
    close(optim.global_norm(tg), jopt.global_norm(
        jax.tree.map(jnp.asarray, grads)))
    for g, w, orig in zip(tree.leaves(tc), jax.tree.leaves(jc),
                          tree.leaves(tg)):
        assert g.dtype == orig.dtype
        close(g.float(), np.asarray(w, np.float32))
    # in place: the same values, the norm before clipping
    norm = optim.clip_by_global_norm_(tg, max_norm)
    assert float(norm) == float(tn)
    for a, b in zip(tree.leaves(tg), tree.leaves(tc)):
        assert torch.equal(a, b)


def test_optimizers_converge_on_a_quadratic():
    """The reference's own check (tests/test_data_optim_ckpt.py), on the
    port's in-place update."""
    for opt in (optim.sgd(0.1), optim.sgd(0.1, momentum=0.9),
                optim.adamw(0.1)):
        params = {"w": torch.zeros(4)}
        state = opt.init(params)
        for step in range(200):
            grads = {"w": 2 * (params["w"] - 3.0)}
            opt.update_(params, grads, state, torch.tensor(step))
        torch.testing.assert_close(params["w"], torch.full((4,), 3.0),
                                   atol=1e-2, rtol=0)
