"""The port's continuous-batching server (``repro_torch/serving``) against
the reference's ``BatchedServer`` on the CPU, at ``.reduced()`` size on the
reference's weights (``convert.params_from_jax``), and the per-slot cache
write it needs.

- ``_write_at`` with a (B,) position past the cache: the reference's
  vmapped ``lax.dynamic_update_slice`` clamps each row's position into the
  cache, so a decode step at positions [T0, T + 5] writes row 1 at T - 1.
  The port's decode step (``make_serve_step``) is held to the reference's
  on the same weights and cache, for the bf16 and the int8 cache.
- ``BatchedServer``: the reference's tests/test_serving.py on the port,
  each request's tokens equal to the reference server's on the same
  weights and prompts, for granite-8b and olmo-1b, Jamba without experts
  and xLSTM (prompts of whole reduced chunks of 32, as xLSTM's prefill
  needs); a run in which a freed slot's position passes ``max_len - 1``
  while another slot decodes; DeepSeek-V2 (MLA) raises in both.

Tolerances: tokens equal (greedy argmax over logits that agree to ~1e-5
relative, tests/test_torch_transformer.py); decode logits 1e-2, as the
bf16 cache's elsewhere (tests/test_torch_transformer.py); the bf16 cache
within one bf16 step (rtol 2^-7) with under 1e-3 of elements differing;
the int8 cache's values within one step at under 1e-3 of elements, as
tests/test_torch_kv_quant.py; per-slot Mamba and xLSTM states (float32)
after decode steps 1e-3, as the Mamba state's in
tests/test_torch_transformer.py (each step feeds the next layers what its
attention read from the bf16 cache).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serving import BatchedServer as JServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serving import BatchedServer, Request  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402

from test_torch_transformer import JAMBA, arch_cfgs, close  # noqa: E402

MAX_LEN = 48
B, T0, T = 2, 8, 16


def _pair(name, max_len=MAX_LEN, **changes):
    cfg, jcfg = arch_cfgs(name, **changes)
    jm, m = jbuild(jcfg, max_seq=max_len), build_model(cfg, max_seq=max_len)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, m, jp, tp


def _close_cache(got, want):
    """A cache tree against the reference's: bf16 leaves within one bf16
    step, int8 leaves within one step, float32 states within 1e-3."""
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        elif g.dtype == torch.bfloat16:
            close(g, w, rtol=2 ** -7, atol=1e-5)
            assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-3
        else:
            close(g, w, rtol=0, atol=1e-3)


# ----------------------------------------------- the per-slot write --
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_past_the_cache_clamps_as_the_reference(quantized):
    """Decode steps with per-slot positions [t, T + 5 + t]: row 1 lies past
    the cache (T positions), and the reference writes its K/V at T - 1."""
    cfg, jm, m, jp, tp = _pair("olmo-1b")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jc = jm.cache_init(B, T, quantized=quantized)
    tc = m.cache_init(B, T, quantized=quantized, device="cpu")
    _, jc, _ = jax.jit(lambda p, t, c: jm.apply(p, {"tokens": t},
                                                mode="prefill", cache=c))(
        jp, jnp.asarray(toks[:, :T0]), jc)
    _, tc, _ = m.apply(tp, {"tokens": torch.as_tensor(toks[:, :T0])},
                       mode="prefill", cache=tc)
    jstep = jax.jit(jsteps.make_serve_step(jm))
    tstep = steps.make_serve_step(m)
    for t in range(T0, T0 + 3):
        pos = np.array([t, T + 5 + t - T0], np.int32)
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.asarray(pos))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc,
                       torch.as_tensor(pos))
        close(tl, jl, rtol=0, atol=1e-2)
        _close_cache(tc, jc)
    # row 1's last position holds the last step's K/V, as the reference's
    assert tc["sub0"]["k"][:, 1, T - 1].abs().max() > 0


def test_write_slot_is_the_references():
    """A B = 1 cache written into slot 2 of a batched one, leaf by leaf,
    in place."""
    cfg, jm, m, _, _ = _pair(JAMBA, moe=None)
    rng = np.random.default_rng(1)
    single = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                          jm.cache_init(1, T))
    batched = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                           jm.cache_init(3, T))
    want = jscheduler._write_slot(batched, single, 2)
    tb = params_from_jax(batched, "cpu")
    leaves = tree.leaves(tb)
    got = scheduler._write_slot(tb, params_from_jax(single, "cpu"), 2)
    assert all(a is b for a, b in zip(tree.leaves(got), leaves))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        close(g, w, rtol=0, atol=0)


# ------------------------------------------------------------- server --
def _serve_both(name, plens, n_new, max_batch=2, max_len=MAX_LEN, seed=10,
                **changes):
    """Both servers on the same weights and seeded prompts: (port requests,
    port stats, reference requests, reference stats, both servers)."""
    cfg, jm, m, jp, tp = _pair(name, max_len, **changes)
    prompts = [np.random.default_rng(seed + i).integers(
        0, cfg.vocab_size, (p,)).astype(np.int32) for i, p in enumerate(plens)]
    news = n_new if isinstance(n_new, list) else [n_new] * len(plens)
    jserver = JServer(jm, jp, max_batch=max_batch, max_len=max_len)
    tserver = BatchedServer(m, tp, max_batch=max_batch, max_len=max_len,
                            device="cpu")
    jreqs = [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    treqs = [Request(uid=i, prompt=torch.as_tensor(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    for jr, tr in zip(jreqs, treqs):
        jserver.submit(jr)
        tserver.submit(tr)
    return (treqs, tserver.run(), jreqs, jserver.run(), tserver, jserver,
            (m, tp, prompts))


def _greedy_alone(m, tp, prompt, n_new, max_len=MAX_LEN):
    """One request alone through the port: B = 1 prefill, int positions."""
    cache = m.cache_init(1, max_len, device="cpu")
    logits, cache, _ = m.apply(tp, {"tokens": torch.as_tensor(prompt)[None]},
                               mode="prefill", cache=cache)
    toks = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache, _ = m.apply(
            tp, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)},
            mode="decode", cache=cache, cache_pos=pos)
        toks.append(int(logits[0, 0].argmax()))
    return toks


def test_batched_server_matches_single_request():
    """tests/test_serving.py's first test: mixed-length requests through a
    2-slot server give each request's tokens decoded alone, and the
    reference server's tokens."""
    treqs, stats, jreqs, jstats, *_, (m, tp, prompts) = _serve_both(
        "granite-8b", [5, 9, 7, 12], 6)
    assert stats == jstats and stats["completed"] == 4
    assert all(r.done and len(r.output) == 6 for r in treqs)
    for tr, jr, p in zip(treqs, jreqs, prompts):
        assert tr.output == jr.output, (tr.uid, tr.output, jr.output)
        assert tr.output == _greedy_alone(m, tp, p, 6)


def test_server_interleaves_beyond_batch():
    """tests/test_serving.py's second test: more requests than slots, later
    ones joining as slots free; the reference server's tokens and stats."""
    cfg, jm, m, jp, tp = _pair("olmo-1b")
    jserver = JServer(jm, jp, max_batch=2, max_len=MAX_LEN)
    server = BatchedServer(m, tp, max_batch=2, max_len=MAX_LEN, device="cpu")
    treqs = [Request(uid=i, prompt=torch.arange(4 + i, dtype=torch.int32),
                     max_new_tokens=3) for i in range(5)]
    jreqs = [JRequest(uid=i, prompt=jnp.arange(4 + i, dtype=jnp.int32),
                      max_new_tokens=3) for i in range(5)]
    for tr, jr in zip(treqs, jreqs):
        server.submit(tr)
        jserver.submit(jr)
    stats = server.run()
    assert stats == jserver.run()
    assert stats["completed"] == 5 and stats["prefills"] == 5
    assert stats["steps"] >= 5
    assert [r.output for r in treqs] == [r.output for r in jreqs]


@pytest.mark.parametrize("name,changes,plens", [
    (JAMBA, {"moe": None}, [5, 32, 9, 12]),
    ("xlstm-1.3b", {}, [32, 64, 32])], ids=["jamba-no-experts", "xlstm"])
def test_recurrent_archs_match_the_reference_server(name, changes, plens):
    """Per-slot Mamba and xLSTM states, written into their slots by
    ``_write_slot`` and decoded together: the reference server's tokens and
    its cache after the run."""
    treqs, stats, jreqs, jstats, tserver, jserver, _ = _serve_both(
        name, plens, [6, 4, 7, 5][:len(plens)], max_len=80, **changes)
    assert stats == jstats and stats["prefills"] == len(plens)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs)
    _close_cache(tserver.cache, jserver.cache)


def test_a_freed_slot_passes_the_cache_end_as_in_the_reference():
    """A 24-position cache: a request of 20 + 4 tokens frees slot 0 at
    position 23 while slot 1 decodes 14 tokens, so slot 0's position
    advances to 33; both servers write its row's last position and give
    the same tokens and cache."""
    treqs, stats, jreqs, jstats, tserver, jserver, _ = _serve_both(
        "olmo-1b", [20, 3], [4, 14], max_len=24)
    assert stats == jstats and stats["completed"] == 2
    assert int(tserver.pos[0]) == int(jserver.pos[0]) == 33 > 24 - 1
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == [4, 14]
    _close_cache(tserver.cache, jserver.cache)


def test_mla_raises_in_both_servers():
    """DeepSeek-V2's latent cache takes one decode position for every row,
    in the reference too (``mla_apply`` writes at (0, cache_pos, 0)): both
    servers prefill, then raise at the first batched decode."""
    cfg, jm, m, jp, tp = _pair("deepseek-v2-236b")
    jserver = JServer(jm, jp, max_batch=2, max_len=MAX_LEN)
    server = BatchedServer(m, tp, max_batch=2, max_len=MAX_LEN, device="cpu")
    jserver.submit(JRequest(uid=0, prompt=jnp.arange(5, dtype=jnp.int32),
                            max_new_tokens=3))
    server.submit(Request(uid=0, prompt=torch.arange(5, dtype=torch.int32),
                          max_new_tokens=3))
    with pytest.raises(TypeError):
        jserver.run()
    with pytest.raises(NotImplementedError, match="attention.py:311-314"):
        server.run()
    assert server._stats["prefills"] == 1


def test_server_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    cfg, jm, m, jp, tp = _pair("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(m, tp, max_batch=2, max_len=MAX_LEN)
