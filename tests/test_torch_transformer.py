"""The port's dense transformer against the reference on olmo-1b
``.reduced()`` (2 layers, d 256, 4 heads, hd 64, vocab 512, float32): the
configurations, the modules (norms, RoPE, FFNs), ``Model.init`` under the
reference's key schedule, prefill, the bf16 KV cache and decode, with and
without a sliding window, and one bfloat16 model.  Weights are carried
across with ``convert.params_from_jax``; the JAX steps are jitted.

Tolerances, and why:
- modules, f32: 1e-5 (fp32 math in both, ``log``/``cos`` and sums may
  differ in the last bit);
- init: 1e-6 (``normal`` goes through erfinv, whose ``log1p`` differs in
  the last bit);
- prefill logits, f32: atol 2e-3 on logits up to ~200 (1e-5 relative);
- the KV cache is bf16 in both packages (even for an f32 model): an element
  whose f32 value lies within rounding error of a bf16 tie rounds the other
  way, so elements agree within one bf16 step (rtol 2^-7), and few differ;
- decode logits, f32: atol 1e-2 — they read that cache, where one bf16
  step in an element moves a logit by up to ~1e-2;
- a model's decode against its own full forward: rtol 2e-2 as in the
  reference's tests/test_decode_equivalence.py (decode reads the bf16
  cache, the full forward the f32 K/V), with atol 0.25: OLMo ties its
  logits to a unit-normal embedding table, so they reach ~200 where the
  reference's test model (granite) gives O(1) logits, and a K/V element's
  rounding by 2^-9 moves them by up to ~0.1;
- the bfloat16 model: logits are bf16 products, whose step is 1.0 between
  128 and 256, rounded at other places in the two frameworks: atol 2.0
  (two steps).  Its K/V are bf16 products too, whose one-step differences
  RoPE mixes (x1 cos - x2 sin), so a small element can differ by the step
  of its larger partner: atol 2^-5, the bf16 step for |k| in [4, 8).

Jamba without its experts (``moe=None``), ``.reduced()``: 16 layers, two
groups of (mamba x 4, attn, mamba x 3), d 256, d_inner 512, N 8, chunk
32, untied logits of O(1), float32.  The reference's prefill sums the
recurrence with an associative scan, the port step by step (the plain
version of its kernel):
- full-forward and prefill logits: 1e-4 (measured ~1e-5 on logits up to
  ~5);
- the mamba state after prefill (h, conv; float32 in both): 1e-4;
- decode logits: 1e-2, as OLMo's, since the attention layers read the
  bf16 KV cache (measured ~2e-4);
- the mamba state after the decode steps: 1e-3, since each step feeds
  the next layers' states with what it read from that cache (measured
  ~2e-4 on |h| up to ~8);
- decode against the port's own full forward: rtol = atol = 2e-2, the
  reference's tests/test_decode_equivalence.py tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import configs, random as R, tree  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import modules  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

B, T0, T = 2, 8, 16
JAMBA = "jamba-v0.1-52b"
MOE_ARCHS = ["jamba-v0.1-52b", "deepseek-v2-236b", "arctic-480b"]
SUPPORTED = (["olmo-1b", "qwen1.5-4b", "granite-8b", "qwen1.5-110b"]
             + MOE_ARCHS + ["whisper-medium", "llava-next-mistral-7b",
                            "xlstm-1.3b"])
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


DECODE_VS_FULL = dict(rtol=2e-2, atol=0.25)


def tkey(jkey):
    return R.as_key(np.asarray(jkey), "cpu")


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **kw)


def arch_cfgs(name="olmo-1b", dtype=None, **changes):
    """``name``'s configuration with ``changes`` (``moe=None`` gives Jamba
    without its experts), reduced, in both packages; ``dtype``, a JAX
    type, sets the parameters' type."""
    cfg = dataclasses.replace(configs.get_arch(name), **changes).reduced()
    jcfg = dataclasses.replace(jconfigs.get_arch(name), **changes).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=DTYPES[dtype])
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    return cfg, jcfg


def _tokens():
    return np.random.default_rng(0).integers(0, 512, (B, T)).astype(np.int32)


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_configs_are_the_reference_configs(name):
    for got, want in ((configs.get_arch(name), jconfigs.get_arch(name)),
                      (configs.get_arch(name).reduced(),
                       jconfigs.get_arch(name).reduced())):
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "param_dtype":
                assert g == DTYPES[w]
            elif dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w)
            else:
                assert g == w, f.name
        assert got.num_params() == want.num_params()
    assert configs.get_arch("olmo-1b").num_params() == 1_176_764_416


def test_every_reference_arch_is_built():
    assert sorted(SUPPORTED) == sorted(jconfigs.ARCHS)


# ------------------------------------------------------------- modules --
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norms(kind):
    x = np.random.default_rng(1).normal(2.0, 3.0, (3, 5, 64)).astype(np.float32)
    jp = jmod.norm_init(kind, 64, jnp.float32)
    if kind != "layernorm_np":
        jp = {k: jnp.linspace(0.5, 1.5, 64) + i for i, k in enumerate(sorted(jp))}
    got = modules.norm_apply(kind, params_from_jax(jp, "cpu"), torch.as_tensor(x))
    close(got, jmod.norm_apply(kind, jp, jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    assert tree.structure(modules.norm_init(kind, 64, device="cpu")) == \
        tree.structure(jax.tree.map(lambda _: None, jp))


@pytest.mark.parametrize("hd", [64, 128])
def test_rope_prefill_and_decode_positions(hd):
    x = np.random.default_rng(2).normal(size=(2, 9, 3, hd)).astype(np.float32)
    pre = np.arange(9)[None]
    close(modules.apply_rope(torch.as_tensor(x), torch.as_tensor(pre), 1e4),
          jmod.apply_rope(jnp.asarray(x), jnp.asarray(pre), 1e4),
          rtol=1e-5, atol=1e-5)
    dec = np.array([[1055], [17]])
    close(modules.apply_rope(torch.as_tensor(x[:, :1]), torch.as_tensor(dec), 1e4),
          jmod.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(dec), 1e4),
          rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_ffn(kind):
    jk = jax.random.PRNGKey(3)
    jp = jmod.ffn_init(jk, kind, 32, 96, jnp.float32)
    tp = modules.ffn_init(tkey(jk), kind, 32, 96, torch.float32)
    for g, w in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        close(g, w, rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(3).normal(size=(2, 5, 32)).astype(np.float32)
    close(modules.ffn_apply(kind, params_from_jax(jp, "cpu"), torch.as_tensor(x)),
          jmod.ffn_apply(kind, jp, jnp.asarray(x)), rtol=1e-5, atol=1e-5)


def test_softmax_xent():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 6)).astype(np.int32)
    close(steps.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels)),
          jsteps.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)),
          rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- model --
@pytest.mark.parametrize("name", SUPPORTED)
def test_init_gives_the_reference_weights(name):
    cfg, jcfg = arch_cfgs(name)
    jk = jax.random.PRNGKey(0)
    want = jbuild(jcfg).init(jk)
    got = build_model(cfg).init(tkey(jk))
    assert tree.structure(got) == tree.structure(jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)


def test_bf16_tree_round_trips_bit_for_bit():
    _, jcfg = arch_cfgs(dtype=jnp.bfloat16)
    want = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(want, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(tp))
    back = params_to_numpy(tp)
    for g, w in zip(tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.view(np.uint16) == w.view(np.uint16)).all()


def _prefill_and_decode(dtype, window):
    """Both packages on the same weights and tokens: prefill T0 tokens,
    then decode T0..T-1 one at a time.  Returns per-step logit pairs, the
    caches after prefill, and the port's model, weights and logits."""
    cfg, jcfg = arch_cfgs(dtype=dtype)
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens()
    jl, jc = jax.jit(jsteps.make_prefill_step(jm, T))(
        jp, {"tokens": jnp.asarray(toks[:, :T0])})
    tl, tc = steps.make_prefill_step(m, T)(
        tp, {"tokens": torch.as_tensor(toks[:, :T0])})
    pairs = [(tl, jl)]
    caches = (tree.map(torch.clone, tc), jc)
    jstep = jax.jit(jsteps.make_serve_step(jm, window=window))
    tstep = steps.make_serve_step(m, window=window)
    for t in range(T0, T):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc, t)
        pairs.append((tl, jl))
    return pairs, caches, m, tp, toks


@pytest.mark.parametrize("window", [None, 4])
def test_prefill_cache_and_decode_match_the_reference(window):
    pairs, (tc, jc), m, tp, toks = _prefill_and_decode(jnp.float32, window)
    (tl, jl), decode = pairs[0], pairs[1:]
    assert tl.dtype == torch.float32 and tl.shape == (B, 512)
    close(tl, jl, rtol=0, atol=2e-3)
    for name in ("k", "v"):
        g, w = tc["sub0"][name], jc["sub0"][name]
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        close(g, w, rtol=2 ** -7, atol=0)
        assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-3
    assert len(decode) == 8
    for tl, jl in decode:
        close(tl, jl, rtol=0, atol=1e-2)
    # the port's decode equals its own full forward at the last position
    full, _, _ = m.apply(tp, {"tokens": torch.as_tensor(toks)}, mode="train",
                         window=window)
    close(decode[-1][0], full[:, T - 1], **DECODE_VS_FULL)


def test_decode_equals_the_full_forward_at_every_position():
    cfg, _ = arch_cfgs()
    m = build_model(cfg, max_seq=T)
    tp = m.init(R.PRNGKey(5, "cpu"))
    toks = torch.as_tensor(_tokens())
    full, _, _ = m.apply(tp, {"tokens": toks}, mode="train")
    cache = m.cache_init(B, T, device="cpu")
    _, cache, _ = m.apply(tp, {"tokens": toks[:, :T0]}, mode="prefill",
                          cache=cache)
    for t in range(T0, T):
        logits, cache, _ = m.apply(tp, {"tokens": toks[:, t:t + 1]},
                                   mode="decode", cache=cache, cache_pos=t)
        close(logits[:, 0], full[:, t], **DECODE_VS_FULL)


def test_bfloat16_model_matches_the_reference():
    pairs, (tc, jc), *_ = _prefill_and_decode(jnp.bfloat16, None)
    for tl, jl in pairs:
        close(tl, jl, rtol=0, atol=2.0)
    close(tc["sub0"]["k"], jc["sub0"]["k"], rtol=2 ** -7, atol=2 ** -5)


@pytest.mark.parametrize("window", [None, 4])
def test_per_slot_decode_positions_match_the_reference(window):
    """Decode with a (B,) ``cache_pos`` (one position per slot, as a
    continuous-batching scheduler gives): the cache writes, the windowed
    reads and the per-row valid lengths follow each row's own position."""
    cfg, jcfg = arch_cfgs()
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens()
    _, jc = jax.jit(jsteps.make_prefill_step(jm, T))(
        jp, {"tokens": jnp.asarray(toks[:, :T0])})
    _, tc = steps.make_prefill_step(m, T)(
        tp, {"tokens": torch.as_tensor(toks[:, :T0])})
    jstep = jax.jit(jsteps.make_serve_step(jm, window=window))
    tstep = steps.make_serve_step(m, window=window)
    for t in range(T0, T):
        pos = np.array([t, T0 + (t - T0) // 2], np.int32)
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.asarray(pos))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc,
                       torch.as_tensor(pos))
        close(tl, jl, rtol=0, atol=1e-2)


# ------------------------------------------------ jamba without experts --
def test_jamba_without_experts_init_gives_the_reference_weights():
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    assert build_model(cfg).cfg is cfg
    jk = jax.random.PRNGKey(0)
    want = jbuild(jcfg).init(jk)
    got = build_model(cfg).init(tkey(jk))
    assert tree.structure(got) == tree.structure(jax.tree.map(lambda _: None, want))
    assert "ffn" in got["groups"]["sub0"] and "A_log" in got["groups"]["sub0"]["mixer"]
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)


def test_jamba_without_experts_bf16_tree_round_trips_bit_for_bit():
    """A bf16 model keeps A_log and D in float32: a tree of both types
    crosses ``convert.py`` leaf by leaf, and so does the cache."""
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    jm = jbuild(jcfg, max_seq=T)
    for want in (jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))),
                 jax.tree.map(np.asarray, jm.cache_init(B, T))):
        back = params_to_numpy(params_from_jax(want, "cpu"))
        for g, w in zip(tree.leaves(back), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert (g.view(np.uint8) == w.view(np.uint8)).all()
    dtypes = {str(w.dtype) for w in jax.tree.leaves(want)}
    assert dtypes == {"float32", "bfloat16"}


def test_jamba_without_experts_forward_matches_the_reference():
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens()
    jl, _, _ = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, mode="train"))(
        jp, jnp.asarray(toks))
    tl, cache, aux = m.apply(tp, {"tokens": torch.as_tensor(toks)},
                             mode="train")
    assert cache is None and float(aux) == 0.0
    assert tl.dtype == torch.float32 and tl.shape == (B, T, 512)
    close(tl, jl, rtol=1e-4, atol=1e-4)


def test_jamba_without_experts_prefill_cache_and_decode_match_the_reference():
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens()
    jl, jc = jax.jit(jsteps.make_prefill_step(jm, T))(
        jp, {"tokens": jnp.asarray(toks[:, :T0])})
    tl, tc = steps.make_prefill_step(m, T)(
        tp, {"tokens": torch.as_tensor(toks[:, :T0])})
    close(tl, jl, rtol=1e-4, atol=1e-4)
    assert tree.structure(tc) == tree.structure(jax.tree.map(lambda _: None, jc))
    for i, kind in enumerate(cfg.block_pattern):
        g, w = tc[f"sub{i}"], jc[f"sub{i}"]
        if kind == "mamba":
            for name in ("h", "conv"):
                assert g[name].dtype == torch.float32
                close(g[name], w[name], rtol=1e-4, atol=1e-4)
        else:
            assert g["k"].dtype == torch.bfloat16
            close(g["k"], w["k"], rtol=2 ** -7, atol=0)
    jstep = jax.jit(jsteps.make_serve_step(jm))
    tstep = steps.make_serve_step(m)
    for t in range(T0, T):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc, t)
        close(tl, jl, rtol=0, atol=1e-2)
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            for name in ("h", "conv"):
                close(tc[f"sub{i}"][name], jc[f"sub{i}"][name], rtol=1e-3,
                      atol=1e-3)


def test_jamba_without_experts_decode_equals_the_full_forward():
    """The reference's tests/test_decode_equivalence.py property on the
    port: prefill T0 tokens, decode the rest, against one full forward."""
    cfg, _ = arch_cfgs(JAMBA, moe=None)
    m = build_model(cfg, max_seq=T)
    tp = m.init(R.PRNGKey(0, "cpu"))
    toks = torch.as_tensor(_tokens())
    full, _, _ = m.apply(tp, {"tokens": toks}, mode="train")
    cache = m.cache_init(B, T, device="cpu")
    _, cache, _ = m.apply(tp, {"tokens": toks[:, :T0]}, mode="prefill",
                          cache=cache)
    for t in range(T0, T):
        logits, cache, _ = m.apply(tp, {"tokens": toks[:, t:t + 1]},
                                   mode="decode", cache=cache, cache_pos=t)
        close(logits[:, 0], full[:, t], rtol=2e-2, atol=2e-2)



# ------------------------------------- the MoE archs: experts and MLA --
def _moe_pair(name, seed=0):
    cfg, jcfg = arch_cfgs(name)
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(seed))
    return cfg, jm, m, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_moe_layers_sit_where_the_reference_puts_them():
    """Jamba: experts on sublayers 1, 3, 5, 7 of each group (``_has_moe``:
    ``i % 2 == 1``), a dense FFN on the others; DeepSeek-V2 and Arctic:
    experts on every layer, MLA as DeepSeek-V2's mixer."""
    for name, moe_subs in ((MOE_ARCHS[0], {1, 3, 5, 7}), (MOE_ARCHS[1], {0}),
                           (MOE_ARCHS[2], {0})):
        cfg, _ = arch_cfgs(name)
        p = build_model(cfg).init(R.PRNGKey(0, "cpu"))["groups"]
        got = {i for i in range(cfg.group_size) if "moe" in p[f"sub{i}"]}
        assert got == moe_subs
        for i in range(cfg.group_size):
            assert ("ffn" in p[f"sub{i}"]) == (i not in moe_subs)
            assert ("wkv_b" in p[f"sub{i}"]["mixer"]) == (name == MOE_ARCHS[1])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_arch_forward_logits_and_aux_match_the_reference(name):
    """Logits within 1e-4 (a float32 stack of 2 to 16 layers on logits of
    O(1)) and the summed load-balance loss within 1e-6."""
    cfg, jm, m, jp, tp = _moe_pair(name, 2)
    toks = _tokens()
    jl, _, jaux = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, mode="train"))(
        jp, jnp.asarray(toks))
    tl, cache, aux = m.apply(tp, {"tokens": torch.as_tensor(toks)},
                             mode="train")
    assert cache is None and tl.shape == (B, T, 512)
    close(tl, jl, rtol=1e-4, atol=1e-4)
    assert aux.dtype == torch.float32 and float(aux) > 0
    close(aux, jaux, rtol=0, atol=1e-6)


def test_jamba_with_experts_aux_is_the_reference_sum():
    """``Model.apply`` sums every MoE layer's aux over groups and
    sublayers, as the reference does (it used to return 0)."""
    cfg, jm, m, jp, tp = _moe_pair(MOE_ARCHS[0], 4)
    toks = _tokens()
    _, _, jaux = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="prefill",
                          cache=jm.cache_init(B, T))
    _, _, aux = m.apply(tp, {"tokens": torch.as_tensor(toks)}, mode="prefill",
                        cache=m.cache_init(B, T, device="cpu"))
    n_moe = cfg.num_groups * len(range(1, cfg.group_size, 2))
    assert n_moe == 8
    close(aux, jaux, rtol=0, atol=1e-6)
    # each layer's share is near router_aux_loss (balanced routing gives 1x)
    assert 0.5 * n_moe * 0.01 < float(aux) < 2 * n_moe * 0.01


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_arch_prefill_and_decode_match_the_reference(name):
    """Prefill logits 1e-4 as the forward's; the caches: bf16 K/V or
    latents within one bf16 step (rtol 2^-7) plus atol 1e-5, the float32
    error the layers below carry in (measured ~2e-6, seen on elements near
    1e-4), and the float32 mamba state 1e-4 as Jamba's without experts;
    decode 1e-2 as OLMo's and Jamba's without experts (the attention
    layers read the bf16 cache)."""
    cfg, jm, m, jp, tp = _moe_pair(name)
    toks = _tokens()
    jl, jc = jax.jit(jsteps.make_prefill_step(jm, T))(
        jp, {"tokens": jnp.asarray(toks[:, :T0])})
    tl, tc = steps.make_prefill_step(m, T)(
        tp, {"tokens": torch.as_tensor(toks[:, :T0])})
    close(tl, jl, rtol=1e-4, atol=1e-4)
    assert tree.structure(tc) == tree.structure(jax.tree.map(lambda _: None, jc))
    for g, w in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        if g.dtype == torch.bfloat16:
            close(g, w, rtol=2 ** -7, atol=1e-5)
        else:
            close(g, w, rtol=1e-4, atol=1e-4)
    jstep = jax.jit(jsteps.make_serve_step(jm))
    tstep = steps.make_serve_step(m)
    for t in range(T0, T):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc, t)
        close(tl, jl, rtol=0, atol=1e-2)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_arch_decode_equals_the_full_forward(name):
    """The reference's tests/test_decode_equivalence.py property (rtol =
    atol = 2e-2) on the port's own model."""
    cfg, _ = arch_cfgs(name)
    m = build_model(cfg, max_seq=T)
    tp = m.init(R.PRNGKey(6, "cpu"))
    toks = torch.as_tensor(_tokens())
    full, _, _ = m.apply(tp, {"tokens": toks}, mode="train")
    cache = m.cache_init(B, T, device="cpu")
    _, cache, _ = m.apply(tp, {"tokens": toks[:, :T0]}, mode="prefill",
                          cache=cache)
    for t in range(T0, T):
        logits, cache, _ = m.apply(tp, {"tokens": toks[:, t:t + 1]},
                                   mode="decode", cache=cache, cache_pos=t)
        close(logits[:, 0], full[:, t], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_arch_bf16_tree_round_trips_bit_for_bit(name):
    """A bf16 MoE model keeps its routers float32 (and Jamba's A_log and
    D): the tree crosses ``convert.py`` leaf by leaf, as does the cache."""
    _, jcfg = arch_cfgs(name, dtype=jnp.bfloat16)
    jm = jbuild(jcfg, max_seq=T)
    want = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    routers = [w for path, w in jax.tree_util.tree_leaves_with_path(want)
               if "router" in jax.tree_util.keystr(path)]
    assert routers and all(w.dtype == np.float32 for w in routers)
    for tree_ in (want, jax.tree.map(np.asarray, jm.cache_init(B, T))):
        back = params_to_numpy(params_from_jax(tree_, "cpu"))
        for g, w in zip(tree.leaves(back), jax.tree.leaves(tree_)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert (g.view(np.uint8) == w.view(np.uint8)).all()


@pytest.mark.parametrize("name", ["olmo-1b", "jamba-v0.1-52b"])
def test_weights_are_freed_without_the_garbage_collector(name):
    """No reference cycle holds a drawn model: its leaves go when the last
    reference does.  (``tree.unflatten`` once built trees with a closure
    that called itself, a cycle that kept every leaf until a collection.)"""
    import gc
    import weakref
    cfg, _ = arch_cfgs(name)
    gc.collect()
    gc.disable()
    try:
        params = build_model(cfg).init(R.PRNGKey(0, "cpu"))
        refs = [weakref.ref(t) for t in tree.leaves(params)]
        del params
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
