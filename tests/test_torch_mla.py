"""The port's multi-head latent attention (``repro_torch/models/
attention.py``: ``mla_init``, ``mla_cache_init``, ``mla_apply``) against
the reference's (``repro/models/attention.py:253-364``) at DeepSeek-V2
``.reduced()``: d 256, 4 heads, q rank 96, kv rank 64, qk 32 + 16 RoPE, v
32, float32 weights and a bf16 latent cache.  Weights come from the same
key (init) or are carried across bit for bit; inputs from a numpy seed.

Tolerances, and why:
- init: 1e-6 (erfinv's ``log1p`` differs in the last bit);
- prefill output, float32: 1e-5 (the same products summed in another
  order);
- the latent cache is bf16 in both: an element whose float32 value lies
  within rounding error of a bf16 tie rounds the other way, so elements
  agree within one bf16 step (rtol 2^-7), and few differ;
- decode, absorbed and not: both read one bf16 cache (the reference's,
  carried across), and this step's latent is written into it in each
  package, where it may round the other way as above: 1e-4 on outputs of
  O(1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from test_torch_transformer import arch_cfgs, close, tkey  # noqa: E402

DEEPSEEK = "deepseek-v2-236b"
B, T0, T = 2, 8, 16


def _setup(seed=0):
    cfg, jcfg = arch_cfgs(DEEPSEEK)
    jp = jattn.mla_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, tp, x


def _prefill(cfg, jcfg, jp, tp, x):
    pos = np.arange(T0)[None]
    jc = jattn.mla_cache_init(jcfg, B, T)
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x[:, :T0]), cfg=jcfg,
                             mode="prefill", positions=jnp.asarray(pos),
                             cache=jc)
    tc = attention.mla_cache_init(cfg, B, T, device="cpu")
    ty, tc = attention.mla_apply(tp, torch.as_tensor(x[:, :T0]), cfg=cfg,
                                 mode="prefill", positions=torch.as_tensor(pos),
                                 cache=tc)
    return (ty, tc), (jy, jc)


def test_mla_init_gives_the_reference_weights():
    cfg, jcfg = arch_cfgs(DEEPSEEK)
    jk = jax.random.PRNGKey(7)
    want = jattn.mla_init(jk, jcfg)
    got = attention.mla_init(tkey(jk), cfg)
    assert tree.structure(got) == tree.structure(jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)


def test_mla_cache_is_the_bf16_latent():
    cfg, jcfg = arch_cfgs(DEEPSEEK)
    got = attention.mla_cache_init(cfg, B, T, device="cpu")
    want = jattn.mla_cache_init(jcfg, B, T)
    assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
    for k in got:
        assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
    assert got["c_kv"].shape == (B, T, cfg.mla.kv_lora_rank)
    assert got["k_rope"].shape == (B, T, cfg.mla.qk_rope_head_dim)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_prefill_output_and_cache_match_the_reference(mode):
    cfg, jcfg, jp, tp, x = _setup()
    if mode == "train":
        pos = np.arange(T)[None]
        jy, _ = jattn.mla_apply(jp, jnp.asarray(x), cfg=jcfg, mode="train",
                                positions=jnp.asarray(pos))
        ty, tc = attention.mla_apply(tp, torch.as_tensor(x), cfg=cfg,
                                     mode="train", positions=torch.as_tensor(pos))
        assert tc is None
    else:
        (ty, tc), (jy, jc) = _prefill(cfg, jcfg, jp, tp, x)
        for k in ("c_kv", "k_rope"):
            g, w = tc[k], jc[k]
            assert g.dtype == torch.bfloat16
            close(g, w, rtol=2 ** -7, atol=0)
            assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-2
            assert not g[:, T0:].any()
    assert ty.dtype == torch.float32 and ty.shape == jy.shape
    close(ty, jy, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode_matches_the_reference(absorb):
    """Decode steps T0..T-1 on the reference's prefilled cache, carried
    across; each step writes its latent at ``cache_pos`` in place."""
    cfg, jcfg, jp, tp, x = _setup(2)
    _, (_, jc) = _prefill(cfg, jcfg, jp, tp, x)
    tc = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for t in range(T0, T):
        pos = np.full((B, 1), t)
        jy, jc = jattn.mla_apply(jp, jnp.asarray(x[:, t:t + 1]), cfg=jcfg,
                                 mode="decode", positions=jnp.asarray(pos),
                                 cache=jc, cache_pos=jnp.int32(t),
                                 absorb=absorb)
        ty, tc2 = attention.mla_apply(tp, torch.as_tensor(x[:, t:t + 1]),
                                      cfg=cfg, mode="decode",
                                      positions=torch.as_tensor(pos),
                                      cache=tc, cache_pos=t, absorb=absorb)
        assert tc2 is tc and ty.shape == (B, 1, cfg.d_model)
        close(ty, jy, rtol=1e-4, atol=1e-4)
        # carry the reference's cache on, so each step reads one cache
        tc = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")


def test_absorbed_decode_equals_the_materialised_one():
    """The two decode forms are one function of the cache: the port's
    absorbed decode against its own materialised per-head K/V."""
    cfg, jcfg, jp, tp, x = _setup(3)
    (_, tc), _ = _prefill(cfg, jcfg, jp, tp, x)
    pos = np.full((B, 1), T0)
    outs = [attention.mla_apply(
        tp, torch.as_tensor(x[:, T0:T0 + 1]), cfg=cfg, mode="decode",
        positions=torch.as_tensor(pos), cache=tree.map(torch.clone, tc),
        cache_pos=T0, absorb=absorb)[0] for absorb in (True, False)]
    close(outs[0], outs[1].numpy(), rtol=1e-4, atol=1e-4)


def test_mla_per_slot_decode_positions_raise():
    cfg, _, _, tp, x = _setup()
    cache = attention.mla_cache_init(cfg, B, T, device="cpu")
    pos = torch.tensor([T0, T0 + 1])
    with pytest.raises(NotImplementedError,
                       match="src/repro/models/attention.py:311-314"):
        attention.mla_apply(tp, torch.as_tensor(x[:, :1]), cfg=cfg,
                            mode="decode", positions=pos[:, None],
                            cache=cache, cache_pos=pos)
