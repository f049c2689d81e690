"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's (``repro/models/moe.py``, no mesh), at the ``.reduced()`` MoE
configurations: Jamba-v0.1 (4 experts, top-2, no shared ones), DeepSeek-V2
(one shared expert) and Arctic (a parallel dense FFN), d 256, float32
unless a test says otherwise.  Inputs are made from a numpy seed; weights
come from the same key in both packages (``moe_init``) or are carried
across bit for bit (``moe_apply``).

The reference returns no routing, so the routing it computes (the top-k
experts, each pair's position in its expert and the capacity mask) is
rebuilt here from its own lines (``moe.py:168-191``) and held to the port's
``route`` exactly: the order of the K slots decides which pairs a full
expert drops.

Tolerances, and why:
- init: 1e-6 (``normal`` goes through erfinv, whose ``log1p`` differs in
  the last bit); cast to bf16, a float32 draw that lies within that bit
  of a bf16 tie rounds the other way: one bf16 step (rtol 2^-7), in few
  elements;
- float32 outputs and the aux loss: 1e-5 (sums of products in another
  order);
- bfloat16: both round each product to bf16, in other places: the output
  within 2^-6 of its largest magnitude (two bf16 steps there).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_transformer import arch_cfgs, close, tkey  # noqa: E402

JAMBA, DEEPSEEK, ARCTIC = "jamba-v0.1-52b", "deepseek-v2-236b", "arctic-480b"
MOE_ARCHS = [JAMBA, DEEPSEEK, ARCTIC]


def _weights(name, dtype=None, seed=0):
    cfg, jcfg = arch_cfgs(name, dtype=dtype)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, S, d, dtype=np.float32, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(dtype)


def reference_routing(jp, x, jcfg, capacity_factor):
    """The reference's routing, line for line (``moe.py:168-191``)."""
    m = jcfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"]["w"], axis=-1)
    gate, eidx = jax.lax.top_k(probs, K)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    e_flat = eidx.reshape(B, S * K)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1,
                              e_flat[..., None], axis=-1)[..., 0]
    C = max(8, int(capacity_factor * S * K / E + 0.999))
    C = -(-C // 8) * 8
    return (np.asarray(gate), np.asarray(eidx), np.asarray(pos),
            np.asarray(pos < C), C)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_init_gives_the_reference_weights(name):
    cfg, jcfg = arch_cfgs(name)
    jk = jax.random.PRNGKey(3)
    want = jmoe.moe_init(jk, jcfg)
    got = moe.moe_init(tkey(jk), cfg)
    assert tree.structure(got) == tree.structure(jax.tree.map(lambda _: None, want))
    assert ("shared" in got) == (name == DEEPSEEK)
    assert ("dense" in got) == (name == ARCTIC)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)


def test_moe_init_keeps_the_router_float32_in_a_bf16_model():
    cfg, jcfg = arch_cfgs(JAMBA, dtype=jnp.bfloat16)
    jk = jax.random.PRNGKey(4)
    want = jmoe.moe_init(jk, jcfg)
    got = moe.moe_init(tkey(jk), cfg)
    assert got["router"]["w"].dtype == torch.float32
    assert want["router"]["w"].dtype == jnp.float32
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        close(g, w, rtol=2 ** -7, atol=0)


# name, B, S, capacity factor; whether every pair is kept
CASES = {
    "capacity to spare": (JAMBA, 2, 16, 1.25, True),
    "drops": (JAMBA, 2, 32, 0.25, False),
    "shared experts": (DEEPSEEK, 2, 16, 1.25, None),
    "dense residual": (ARCTIC, 2, 16, 1.25, None),
    "decode, S = 1": (JAMBA, 3, 1, 1.25, True),
    "decode, S = 1, shared experts": (DEEPSEEK, 3, 1, 1.25, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_the_reference(case):
    name, B, S, cf, all_kept = CASES[case]
    cfg, jcfg, jp, tp = _weights(name)
    x = _x(B, S, cfg.d_model)
    want_y, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                                      capacity_factor=cf)
    y, aux = moe.moe_apply(tp, torch.as_tensor(x), cfg, capacity_factor=cf)
    assert y.dtype == torch.float32 and y.shape == (B, S, cfg.d_model)
    close(y, want_y, rtol=1e-5, atol=1e-5)
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(aux, want_aux, rtol=1e-5, atol=1e-6)

    gate, eidx, pos, keep, C = reference_routing(jp, jnp.asarray(x), jcfg, cf)
    rt = moe.route(tp, torch.as_tensor(x), cfg, capacity_factor=cf)
    assert rt.capacity == C == moe.capacity(cfg, S, cf)
    assert (rt.eidx.numpy() == eidx).all()
    assert (rt.pos.numpy() == pos).all()
    assert (rt.keep.numpy() == keep).all()
    close(rt.gate, gate, rtol=1e-6, atol=1e-6)
    if all_kept is not None:
        assert bool(keep.all()) == all_kept


def test_dropped_pairs_add_nothing():
    """At capacity factor 0.25 the pairs past C leave the output: a token
    whose pairs are all dropped gets only the residual FFNs (none here)."""
    cfg, _, _, tp = _weights(JAMBA)
    x = torch.as_tensor(_x(2, 32, cfg.d_model))
    rt = moe.route(tp, x, cfg, capacity_factor=0.25)
    dropped = ~rt.keep.reshape(2, 32, cfg.moe.top_k).any(-1)
    assert dropped.any()
    y, _ = moe.moe_apply(tp, x, cfg, capacity_factor=0.25)
    assert (y[dropped] == 0).all() and (y[~dropped] != 0).any(-1).all()


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_bf16_moe_apply_matches_the_reference(name):
    cfg, jcfg, jp, tp = _weights(name, dtype=jnp.bfloat16)
    x = _x(2, 16, cfg.d_model).astype(jnp.bfloat16)
    want_y, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tp, params_from_jax({"x": x}, "cpu")["x"], cfg)
    assert y.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want_y, np.float32)).max())
    close(y, want_y, rtol=0, atol=scale * 2 ** -6)
    close(aux, want_aux, rtol=1e-5, atol=1e-6)


def test_piecewise_weights_equal_one_draw(monkeypatch):
    """A stack of experts drawn in pieces of a few counters, each cast to
    bf16 as it goes, equals the stack drawn at once, bit for bit."""
    cfg, _ = arch_cfgs(JAMBA)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    key = R.PRNGKey(5, "cpu")
    whole = moe.moe_init(key, cfg)
    monkeypatch.setattr(R, "PIECE", 1000)
    pieces = moe.moe_init(key, cfg)
    for g, w in zip(tree.leaves(pieces), tree.leaves(whole)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
