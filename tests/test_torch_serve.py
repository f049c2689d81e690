"""The port's serving driver against the reference's loop, on the CPU:
``serve`` on olmo-1b ``.reduced()`` gives the tokens that the reference's
``launch/serve.py`` loop gives, rebuilt here from the JAX
``make_prefill_step``/``make_serve_step`` on the weights of
``PRNGKey(0)`` and the prompts and sampling keys of ``PRNGKey(1)``.  The
tokens must be equal: both packages draw the same keys, and the logits
agree to ~1e-5 relative (tests/test_torch_transformer.py), far inside the
gaps between the top candidates.  At temperature 1 OLMo's random-weight
logits (up to ~200) leave the sampler no choice; at 300 it has one.

Jamba without its experts (``moe=None``) ``.reduced()`` is served the same
way, greedy and at temperature 300: its mamba layers scan through the
plain version of the ``ssm_scan`` kernel, the reference's through its
associative scan, and its logits agree to ~2e-4 (its attention layers
read the bf16 cache; tests/test_torch_transformer.py).  So are the MoE
archs (Jamba with its experts, DeepSeek-V2, Arctic), greedy and at
temperature 1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from test_torch_transformer import JAMBA, MOE_ARCHS, arch_cfgs  # noqa: E402

BATCH, PROMPT, GEN = 2, 16, 8


def _reference_tokens(temperature, window=None, cfg=None):
    """The reference's loop (repro/launch/serve.py:29-70), jitted."""
    cfg = cfg or jget_arch("olmo-1b").reduced()
    max_len = PROMPT + GEN
    model = jbuild(cfg, max_seq=max_len)
    params = model.init(jax.random.PRNGKey(0))
    prefill = jax.jit(make_prefill_step(model, max_len=max_len))
    step = jax.jit(make_serve_step(model, window=window))
    rng = jax.random.PRNGKey(1)
    prompts = jax.random.randint(rng, (BATCH, PROMPT), 0, cfg.vocab_size)
    logits, cache = prefill(params, {"tokens": prompts})
    tok = logits.argmax(-1)[:, None].astype(jnp.int32)
    out = [tok]
    for t in range(GEN - 1):
        logits, cache = step(params, tok, cache, jnp.int32(PROMPT + t))
        if temperature > 0:
            rng, k = jax.random.split(rng)
            tok = jax.random.categorical(
                k, logits / temperature)[:, None].astype(jnp.int32)
        else:
            tok = logits.argmax(-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), np.asarray(logits)


@pytest.mark.parametrize("temperature,window", [(0.0, None), (1.0, None),
                                                (300.0, None), (300.0, 6)])
def test_serve_gives_the_reference_tokens(temperature, window):
    res = serve_mod.serve(get_arch("olmo-1b").reduced(), batch=BATCH,
                          prompt_len=PROMPT, gen=GEN, window=window,
                          temperature=temperature, device="cpu")
    want, want_logits = _reference_tokens(temperature, window)
    assert res.tokens.dtype == torch.int32
    assert res.tokens.shape == (BATCH, GEN)
    assert (res.tokens.numpy() == want).all()
    # logits up to ~200, read through the bf16 cache: see
    # tests/test_torch_transformer.py
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=0,
                               atol=1e-2)
    assert res.prefill_ms > 0 and res.decode_ms_per_step > 0
    assert res.tokens_per_s > 0


@pytest.mark.parametrize("temperature", [0.0, 300.0])
def test_serve_jamba_without_experts_gives_the_reference_tokens(temperature):
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    res = serve_mod.serve(cfg, batch=BATCH,
                          prompt_len=PROMPT, gen=GEN, temperature=temperature,
                          device="cpu")
    want, want_logits = _reference_tokens(
        temperature, cfg=jcfg)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (BATCH, GEN)
    assert (res.tokens.numpy() == want).all()
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=0,
                               atol=1e-2)


def test_cli_runs_on_the_cpu_and_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    res = serve_mod.main(["--arch", "olmo-1b", "--device", "cpu", "--batch",
                          "2", "--prompt-len", "4", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert "prefill 2x4" in out and "sample:" in out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--arch", "olmo-1b", "--batch", "2",
                        "--prompt-len", "4", "--gen", "3"])


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_serve_moe_archs_give_the_reference_tokens(name, temperature):
    """Jamba with its experts, DeepSeek-V2 (MLA, shared experts) and Arctic
    (a dense residual), reduced, greedy and sampled at temperature 1: their
    logits are O(1) and agree to ~1e-4 (tests/test_torch_transformer.py),
    far inside the gaps the sampler's Gumbel draws leave."""
    cfg, jcfg = arch_cfgs(name)
    res = serve_mod.serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                          temperature=temperature, device="cpu")
    want, want_logits = _reference_tokens(temperature, cfg=jcfg)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (BATCH, GEN)
    assert (res.tokens.numpy() == want).all()
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=0,
                               atol=1e-2)

