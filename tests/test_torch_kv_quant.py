"""The int8 KV cache in the port against the reference, on the CPU:
``_quantize_kv`` / ``_dequantize_kv``, the cache's layout, and prefill and
decode through a quantized cache (int8 values, one bf16 scale per
position and KV head) on granite-8b, olmo-1b (with a sliding window and
per-slot positions) and whisper-medium (its cross K/V stay bf16), all
``.reduced()``, float32.  Inputs are numpy draws from a seed.

Tolerances:
- quantized values: equal, except where x / scale lies within float32
  rounding of a half-way point, which the two packages' divisions may put
  on either side (under 1e-3 of entries, each one step apart); scales
  equal in bf16 (both round the same float32 amax / 127);
- the caches after prefill: the same, on K/V that the two packages compute
  within float32 rounding of each other;
- decode logits: atol 1e-2 of the reference's int8 decode, as the bf16
  cache's (tests/test_torch_transformer.py);
- decode against the port's own full forward: the reference's int8
  tolerance (tests/test_kv_quant.py: rtol 0.1, atol 0.15) on granite, whose
  logits are O(1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

from test_torch_encdec import both, extras  # noqa: E402
from test_torch_transformer import arch_cfgs, close  # noqa: E402

B, T0, T = 2, 8, 16


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [3.0, 1e-3])
def test_quantize_kv_matches_the_reference(dtype, scale):
    x = (np.random.default_rng(0).normal(size=(2, 16, 4, 64)) * scale
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                          # an all-zero row: scale 1e-8
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jattn._quantize_kv(jx)
    tq, ts = attn._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    assert (_bits(js) == ts.view(torch.int16).numpy().view(np.uint16)).all()
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for out in (jnp.float32, jnp.bfloat16):
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        want = jattn._dequantize_kv(jq, js, out)
        got = attn._dequantize_kv(torch.from_numpy(np.array(jq)), ts, tout)
        assert got.dtype == tout
        close(got, want, rtol=0, atol=0)


def test_quantized_cache_layout_is_the_references():
    cfg, jcfg = arch_cfgs("olmo-1b")
    want = jbuild(jcfg).cache_init(B, T, quantized=True)
    got = build_model(cfg).cache_init(B, T, quantized=True, device="cpu")
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def _int8_run(name, window, per_slot):
    """Both packages on the same weights, prompts and extras: prefill T0
    tokens into a quantized cache, then decode T0..T-1.  Returns the logit
    pairs (decode only), the caches after prefill, and the port's model,
    weights, tokens and extras."""
    cfg, jcfg = arch_cfgs(name)
    jm, m = jbuild(jcfg, max_seq=T), build_model(cfg, max_seq=T)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    ext = extras(cfg, 1)
    jb, tb = both({"tokens": toks[:, :T0], **ext})
    jc = jm.cache_init(B, T, quantized=True)
    tc = m.cache_init(B, T, quantized=True, device="cpu")
    _, jc, _ = jax.jit(lambda p, b, c: jm.apply(p, b, mode="prefill",
                                                cache=c))(jp, jb, jc)
    _, tc, _ = m.apply(tp, tb, mode="prefill", cache=tc)
    caches = (tree.map(torch.clone, tc), jc)

    @jax.jit
    def jdecode(p, tok, c, pos):
        logits, c, _ = jm.apply(p, {"tokens": tok}, mode="decode", cache=c,
                                cache_pos=pos, window=window)
        return logits[:, 0], c

    pairs = []
    for t in range(T0, T):
        pos = (np.array([t, T0 + (t - T0) // 2], np.int32) if per_slot
               else np.int32(t))
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.asarray(pos))
        tpos = torch.as_tensor(pos) if per_slot else t
        tl, tc, _ = m.apply(tp, {"tokens": torch.as_tensor(toks[:, t:t + 1])},
                            mode="decode", cache=tc, cache_pos=tpos,
                            window=window)
        pairs.append((tl[:, 0], jl))
    return pairs, caches, m, tp, toks, ext


@pytest.mark.parametrize("name,window,per_slot", [
    ("granite-8b", None, False), ("olmo-1b", 4, False),
    ("olmo-1b", None, True), ("whisper-medium", None, False)])
def test_int8_prefill_and_decode_match_the_reference(name, window, per_slot):
    pairs, (tc, jc), *_ = _int8_run(name, window, per_slot)
    got, want = tree.leaves(tc), jax.tree.leaves(jc)
    assert tree.structure(tc) == tree.structure(
        jax.tree.map(lambda _: None, jc))
    n_int8 = 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int8:
            n_int8 += 1
            diff = np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:                      # the scales, and whisper's cross K/V
            assert g.dtype == torch.bfloat16
            close(g, w, rtol=2 ** -7, atol=1e-5)
            assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-3
    assert n_int8 == 2
    for tl, jl in pairs:
        close(tl, jl, rtol=0, atol=1e-2)


def test_int8_decode_is_close_to_the_full_forward():
    """The reference's tests/test_kv_quant.py on the port: granite-8b
    reduced, decode through the int8 cache against the full forward."""
    pairs, _, m, tp, toks, _ = _int8_run("granite-8b", None, False)
    full, _, _ = m.apply(tp, {"tokens": torch.as_tensor(toks)}, mode="train")
    for t, (tl, _) in zip(range(T0, T), pairs):
        close(tl, full[:, t], rtol=0.1, atol=0.15)


def test_mla_ignores_the_int8_switch():
    """DeepSeek-V2's latent cache is already small: ``quantized`` applies
    to GQA caches only, in both packages."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"), num_layers=1)
    cache = build_model(cfg.reduced()).cache_init(B, T, quantized=True,
                                                  device="cpu")
    assert set(cache["sub0"]) == {"c_kv", "k_rope"}
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(cache))
