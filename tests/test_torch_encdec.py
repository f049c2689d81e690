"""Whisper-medium ``.reduced()`` in the port against the reference, on the
CPU (2 decoder and 2 encoder layers, d 256, 4 heads, hd 64, 64 encoder
frames, learned positions, cross-attention, float32): ``Model.init`` under
the reference's key schedule (the encoder, its positions, the decoder's
learned positions, ``norm_x`` and ``cross`` included), a bf16 tree carried
across bit for bit, train-mode logits, prefill (the cross K/V cache) and
decode through ``make_serve_step`` and ``make_serve_step_encdec``, decode
against the port's own full forward, a train step, and ``serve()``.  Also
``flash_attention``'s CPU gradient where queries and keys differ in number
(cross-attention), against autograd through ``blockwise_attention`` and
``jax.vjp`` of the reference's.

The helpers here take an arch's name: ``tests/test_torch_vision.py`` runs
them on LLaVA-NeXT.  Encoder frames and image rows are numpy draws from a
seed, handed to both packages.

Tolerances are those of ``tests/test_torch_transformer.py`` and
``tests/test_torch_train.py``: init 1e-6; train and prefill logits atol
2e-3; the bf16 caches (self K/V and the cross ``ck``/``cv``) within one
bf16 step (rtol 2^-7), few elements differing, and atol 1e-5 for elements
near 0, float32 sums of O(1) terms whose last bits differ (the cross K/V
take no RoPE, so small sums stay small: ~1e-6 apart); decode logits atol 1e-2
(they read those caches); decode against the port's own full forward
rtol 2e-2, atol 0.25; a train step's gradients within 1e-4 of each leaf's
largest entry, loss, aux and grad_norm within 1e-5 over three steps;
flash's gradient within 1e-5 of each gradient's largest entry (float32
sums of the same products in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jflash)
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.attention import blockwise_attention as jblockwise  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

from test_torch_train import _err, _pair  # noqa: E402
from test_torch_transformer import (  # noqa: E402
    DECODE_VS_FULL, arch_cfgs, close, tkey)

WHISPER = "whisper-medium"
B, T0, T = 2, 8, 16
S_TRAIN = 32                                   # test_torch_train's length


def extras(cfg, seed, batch=B):
    """The inputs beside the tokens, as numpy: encoder frames (scaled as
    the reference's tests/test_decode_equivalence.py draws them) and image
    rows (unit normal, as the embedding rows are)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["encoder_embeds"] = (rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.vision_tokens:
        out["image_embeds"] = rng.normal(
            size=(batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def both(arrays):
    """numpy inputs as (JAX, torch) dicts."""
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def tokens(vocab, n=T, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


def models(name, dtype=None):
    """Both packages' model on the reference's weights: max_seq holds the
    vision prefix and T tokens."""
    cfg, jcfg = arch_cfgs(name, dtype=dtype)
    M = cfg.vision_tokens + T
    jm, m = jbuild(jcfg, max_seq=M), build_model(cfg, max_seq=M)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jm, m, jp, tp


# ------------------------------------------------------- shared checks --
def check_init(name, subtrees):
    cfg, jcfg = arch_cfgs(name)
    M = cfg.vision_tokens + T
    jk = jax.random.PRNGKey(0)
    want = jbuild(jcfg, max_seq=M).init(jk)
    got = build_model(cfg, max_seq=M).init(tkey(jk))
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda _: None, want))
    for path in subtrees:
        node = got
        for part in path.split("/"):
            node = node[part]
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        close(g, w, rtol=1e-6, atol=1e-6)


def check_bf16_round_trip(name):
    _, jcfg = arch_cfgs(name, dtype=jnp.bfloat16)
    want = jax.tree.map(np.asarray, jbuild(
        jcfg, max_seq=jcfg.vision_tokens + T).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(want, "cpu")
    assert tree.structure(tp) == tree.structure(
        jax.tree.map(lambda _: None, want))
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(tp))
    for g, w in zip(tree.leaves(params_to_numpy(tp)), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.view(np.uint16) == w.view(np.uint16)).all()


def check_train_logits(name):
    cfg, jm, m, jp, tp = models(name)
    jb, tb = both({"tokens": tokens(cfg.vocab_size), **extras(cfg, 1)})
    want, _, _ = jm.apply(jp, jb, mode="train")
    got, _, _ = m.apply(tp, tb, mode="train")
    assert got.dtype == torch.float32 and got.shape == (B, T, cfg.vocab_size)
    close(got, want, rtol=0, atol=2e-3)


def prefill_and_decode(name):
    """Prefill T0 tokens (with the arch's extras), then decode T0..T-1 at
    cache positions V + t in both packages.  Returns the logit pairs
    (prefill first), the caches after prefill (port, reference), and the
    port's model, weights, tokens and extras."""
    cfg, jm, m, jp, tp = models(name)
    V, M = cfg.vision_tokens, cfg.vision_tokens + T
    toks, ext = tokens(cfg.vocab_size), extras(cfg, 1)
    jb, tb = both({"tokens": toks[:, :T0], **ext})
    jl, jc = jax.jit(jsteps.make_prefill_step(jm, M))(jp, jb)
    tl, tc = steps.make_prefill_step(m, M)(tp, tb)
    pairs = [(tl, jl)]
    caches = (tree.map(torch.clone, tc), jc)
    jstep = jax.jit(jsteps.make_serve_step(jm))
    tstep = steps.make_serve_step(m)
    for t in range(T0, T):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(V + t))
        tl, tc = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tc, V + t)
        pairs.append((tl, jl))
    return pairs, caches, m, tp, toks, ext


def check_prefill_and_decode(name):
    pairs, (tc, jc), m, tp, toks, ext = prefill_and_decode(name)
    (tl, jl), decode = pairs[0], pairs[1:]
    assert tl.shape == (B, m.cfg.vocab_size)
    close(tl, jl, rtol=0, atol=2e-3)
    got, want = tree.leaves(tc), jax.tree.leaves(jc)
    assert tree.structure(tc) == tree.structure(
        jax.tree.map(lambda _: None, jc))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert tuple(g.shape) == w.shape
        close(g, w, rtol=2 ** -7, atol=1e-5)
        assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-3
    assert len(decode) == T - T0
    for tl, jl in decode:
        close(tl, jl, rtol=0, atol=1e-2)
    # the port's decode equals its own full forward at the last position
    full, _, _ = m.apply(tp, both({"tokens": toks, **ext})[1], mode="train")
    assert full.shape == (B, T, m.cfg.vocab_size)
    close(decode[-1][0], full[:, T - 1], **DECODE_VS_FULL)


def zero_grads(cfg):
    """The leaves whose gradient is 0 in exact arithmetic: the key bias of
    an attention without RoPE adds one constant to every key's score of a
    query."""
    if not cfg.qkv_bias or cfg.pos_emb == "rope":
        return set()
    out = {"/groups/sub0/cross/wk/b"} if cfg.cross_attention else set()
    out.add("/groups/sub0/mixer/wk/b")
    if cfg.encoder_layers:
        out.add("/encoder/mixer/wk/b")
    return out


def check_train_step(name):
    """One state, the same batches (the arch's extras drawn per batch):
    the gradients leaf by leaf, then three steps' metrics, as
    tests/test_torch_train.py holds the other archs."""
    cfg, jm, m, jstep, tstep, jstate, tstate = _pair(name, {})

    def batch(seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, cfg.vocab_size, (B, S_TRAIN)).astype(np.int32)
        labels[:, -3:] = -1
        return both({"tokens": tokens(cfg.vocab_size, S_TRAIN, seed),
                     "labels": labels, **extras(cfg, seed + 100)})

    jb, tb = batch(0)
    (jtot, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jm), has_aux=True))(jstate["params"], jb)
    (ttot, tloss, _), tgrads = steps.make_grad_fn(m)(tstate["params"], tb)
    assert _err(tloss, jloss) < 1e-5 and _err(ttot, jtot) < 1e-5
    jleaves, tleaves = jax.tree.leaves(jgrads), tree.leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    largest = max(float(np.abs(np.asarray(w)).max()) for w in jleaves)
    for path, g, w in zip(tree.paths(tgrads), tleaves, jleaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        if path in zero_grads(cfg):
            # softmax is blind to a shift shared by every key's score, so
            # these gradients are 0 but for rounding in both packages
            assert float(g.abs().max()) <= 1e-6 * largest
            assert float(np.abs(np.asarray(w)).max()) <= 1e-6 * largest
            continue
        assert np.abs(np.asarray(w)).max() > 0
        assert _err(g, w) < 1e-4, path
    jstep = jax.jit(jstep)
    for i in range(3):
        jb, tb = batch(i + 1)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        for k in ("loss", "grad_norm"):
            assert _err(tmet[k], jmet[k]) < 1e-5, (i, k)
        assert float(tmet["aux"]) == float(jmet["aux"]) == 0
    assert int(tstate["step"]) == 3


def reference_serve_tokens(jcfg, prompt, gen):
    """The reference's model API driven as its CLI's loop drives it
    (repro/launch/serve.py), greedy, with the cache and positions sized
    for the vision prefix (V + prompt + gen; decode at V + prompt + t)."""
    V = jcfg.vision_tokens
    max_len = V + prompt + gen
    model = jbuild(jcfg, max_seq=max_len)
    params = model.init(jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, prompt), 0,
                                 jcfg.vocab_size)
    batch = {"tokens": prompts}
    if V:
        batch["image_embeds"] = jnp.zeros((B, V, jcfg.d_model), jnp.float32)
    if jcfg.encoder_layers:
        batch["encoder_embeds"] = jnp.zeros(
            (B, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
    prefill = jax.jit(jsteps.make_prefill_step(model, max_len=max_len))
    logits, cache = prefill(params, batch)
    step = jax.jit(jsteps.make_serve_step(model))
    tok = logits.argmax(-1)[:, None].astype(jnp.int32)
    out = [tok]
    for t in range(gen - 1):
        logits, cache = step(params, tok, cache, jnp.int32(V + prompt + t))
        tok = logits.argmax(-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), np.asarray(logits)


def check_serve(name, prompt=8, gen=5):
    cfg, jcfg = arch_cfgs(name)
    res = serve_mod.serve(cfg, batch=B, prompt_len=prompt, gen=gen,
                          temperature=0.0, device="cpu")
    want, want_logits = reference_serve_tokens(jcfg, prompt, gen)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (B, gen)
    assert (res.tokens.numpy() == want).all()
    close(res.logits, want_logits, rtol=0, atol=1e-2)


# -------------------------------------------------------------- whisper --
def test_whisper_init_gives_the_reference_weights():
    check_init(WHISPER, ["encoder/mixer/wq", "encoder/ffn", "enc_pos/table",
                         "enc_norm/scale", "pos_embed/table",
                         "groups/sub0/norm_x", "groups/sub0/cross/wk/b"])


def test_whisper_bf16_tree_round_trips_bit_for_bit():
    check_bf16_round_trip(WHISPER)


def test_whisper_train_logits_match_the_reference():
    check_train_logits(WHISPER)


def test_whisper_prefill_cross_cache_and_decode_match_the_reference():
    check_prefill_and_decode(WHISPER)


def test_whisper_encdec_serve_step_matches_the_reference():
    """``make_serve_step_encdec`` (the encoder's output in the batch) gives
    the reference's logits, and the port's own ``make_serve_step`` ones
    exactly: decode reads the cross K/V that prefill cached."""
    cfg, jm, m, jp, tp = models(WHISPER)
    M = T
    toks, ext = tokens(cfg.vocab_size), extras(cfg, 1)
    jb, tb = both({"tokens": toks[:, :T0], **ext})
    _, jc = jax.jit(jsteps.make_prefill_step(jm, M))(jp, jb)
    _, tc = steps.make_prefill_step(m, M)(tp, tb)
    tc2 = tree.map(torch.clone, tc)
    j_enc = jm._encode(jp, jb["encoder_embeds"])
    t_enc = m._encode(tp, tb["encoder_embeds"])
    close(t_enc, j_enc, rtol=0, atol=1e-5)
    jstep = jax.jit(jsteps.make_serve_step_encdec(jm))
    tstep = steps.make_serve_step_encdec(m)
    plain = steps.make_serve_step(m)
    for t in range(T0, T):
        tok = toks[:, t:t + 1]
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(t), j_enc)
        tl, tc = tstep(tp, torch.as_tensor(tok), tc, t, t_enc)
        pl, tc2 = plain(tp, torch.as_tensor(tok), tc2, t)
        close(tl, jl, rtol=0, atol=1e-2)
        assert torch.equal(tl, pl)


def test_whisper_train_step_matches_the_reference():
    check_train_step(WHISPER)


def test_whisper_serve_gives_the_reference_tokens():
    check_serve(WHISPER)


@pytest.mark.parametrize("name", [WHISPER, "llava-next-mistral-7b"])
def test_train_cli_feeds_the_stubbed_frontends(name, capsys):
    """``launch/train.py`` gives an encoder-decoder zero frames and a vision
    model zero image rows, as the reference's CLI does, and trains."""
    from repro_torch.launch import train
    train.main(["--arch", name, "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={name} (reduced=True)" in out and out.count("loss=") == 2
    assert out.rstrip().endswith("done")


def test_whisper_bf16_encoder_stays_near_the_reference_float32_one():
    """A bf16 tree: float32 frames run the encoder in float32 in both
    packages (JAX's promotion in the reference, ``dense_apply``'s in the
    port), so the port's output is float32 and equals the reference's
    within float32 rounding: RMS within 2^-19 of the output's RMS (4.2e-7
    read), the largest difference within 2^-17 of its largest entry (7.0e-7
    read).  The cross-attention K/V computed from it and cached as bf16
    (``ck``/``cv``) match the reference's within one bf16 step, few
    elements differing, as ``check_prefill_and_decode`` holds the caches."""
    cfg, jm, m, jp, tp = models(WHISPER, dtype=jnp.bfloat16)
    frames = extras(cfg, 3)["encoder_embeds"]
    want = np.asarray(jm._encode(jp, jnp.asarray(frames)))
    assert want.dtype == np.float32
    got = m._encode(tp, torch.from_numpy(frames))
    assert got.dtype == torch.float32
    diff = got.numpy() - want
    assert np.sqrt((diff ** 2).mean()) <= 2 ** -19 * np.sqrt((want ** 2).mean())
    assert np.abs(diff).max() <= 2 ** -17 * np.abs(want).max()

    jb, tb = both({"tokens": tokens(cfg.vocab_size)[:, :T0],
                   "encoder_embeds": frames})
    _, jc = jax.jit(jsteps.make_prefill_step(jm, T))(jp, jb)
    _, tc = steps.make_prefill_step(m, T)(tp, tb)
    cross = [(g, w) for path, g, w in zip(tree.paths(tc), tree.leaves(tc),
                                          jax.tree.leaves(jc))
             if path.endswith(("/ck", "/cv"))]
    assert len(cross) == 2
    for g, w in cross:
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        close(g, w, rtol=2 ** -7, atol=1e-5)
        assert (g.float().numpy() != np.asarray(w, np.float32)).mean() < 1e-3


@pytest.mark.parametrize("name", [WHISPER, "llava-next-mistral-7b"])
def test_tree_paths_are_the_reference_key_paths(name):
    _, jcfg = arch_cfgs(name)
    cfg, _ = arch_cfgs(name)
    got = build_model(cfg, max_seq=T).init(R.PRNGKey(0, "meta"))
    shapes = jax.eval_shape(jbuild(jcfg, max_seq=T).init,
                            jax.random.PRNGKey(0))
    assert tree.paths(got) == [
        "".join(f"/{k.key}" for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(shapes)]


# ---------------------------------------------------- full-width trees --
@pytest.mark.parametrize("name,max_seq,want", [
    ("whisper-medium", 448, 813_328_384), ("whisper-medium", 64, 812_935_168),
    ("llava-next-mistral-7b", 2944, 7_241_732_096)])
def test_full_width_trees_match_the_references(name, max_seq, want):
    """The full-width parameter trees, shapes only: the port's on the meta
    device, the reference's by ``jax.eval_shape``.  ``num_params()``
    (810,862,592 and 7,241,465,856) counts the cross-attention's weights
    but not the learned positions (max_seq and 1500 rows), the q/k/v biases
    or the norms."""
    cfg = get_arch(name)
    got = build_model(cfg, max_seq=max_seq).init(R.PRNGKey(0, "meta"))
    shapes = jax.eval_shape(jbuild(jconfigs.get_arch(name),
                                   max_seq=max_seq).init,
                            jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree.leaves(got)] == [
        w.shape for w in jax.tree.leaves(shapes)]
    assert sum(t.numel() for t in tree.leaves(got)) == want
    d, layers = cfg.d_model, cfg.num_layers
    norms = (2 + cfg.cross_attention) * layers + 1
    positions, biases = 0, 0
    if cfg.pos_emb == "learned":
        positions = max_seq + cfg.encoder_seq
    if cfg.encoder_layers:
        norms += 2 * cfg.encoder_layers + 1
        biases = 3 * (2 * layers + cfg.encoder_layers)
    per_norm = 2 if cfg.norm == "layernorm" else 1
    assert want - cfg.num_params() == d * (positions + biases
                                           + per_norm * norms)


# ------------------------------------------- flash's gradient, Sq != Sk --
# B, Sq, Sk, H, KV, hd, causal, window: cross-attention's shape (fewer
# queries than keys, no mask), more queries than keys under a causal mask,
# GQA, a window, hd 32 and 80.  Every query sees a key: a row that sees
# none (a window shorter than Sq - Sk) is no shape training makes, and
# there the plain backward gives 0 where autograd of the -1e30 mask gives
# the gradient of a mean over every key (ROADMAP, queue 3).
SQ_SK_CASES = [
    (2, 24, 80, 4, 4, 64, False, None),
    (1, 80, 24, 4, 2, 128, True, None),
    (2, 40, 100, 4, 1, 64, True, None),
    (1, 100, 60, 2, 2, 80, True, 48),
    (2, 17, 64, 8, 2, 32, False, None),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", SQ_SK_CASES)
def test_flash_gradient_at_unequal_lengths_matches_autograd(
        B, Sq, Sk, H, KV, hd, causal, window):
    """``ops.flash_attention`` on CPU tensors that require a gradient runs
    the plain backward (``flash_attention_lse_ref`` then
    ``flash_attention_bwd_ref``): its output and gradients against torch
    autograd through ``blockwise_attention`` (the model's CPU path) and
    ``jax.vjp`` of the reference's oracle."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    a = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    b = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    oa = fa_ops.flash_attention(*a, **kw)
    assert "FlashAttention" in type(oa.grad_fn).__name__
    ob = blockwise_attention(*b, q_block=16, **kw)
    assert _err(oa, ob.detach().numpy()) < 1e-5
    ga = torch.autograd.grad(oa, a, torch.from_numpy(do))
    gb = torch.autograd.grad(ob, b, torch.from_numpy(do))
    jo, vjp = jax.vjp(lambda x, y, z: jflash(x, y, z, **kw), *map(
        jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(do))
    assert _err(oa, jo) < 1e-5
    for g, w, j, t in zip(ga, gb, jg, a):
        assert g.shape == t.shape
        assert _err(g, w.numpy()) < 1e-5 and _err(g, j) < 1e-5
    # the reference's blockwise attention agrees with its oracle here too
    assert _err(oa, jblockwise(*map(jnp.asarray, (q, k, v)), q_block=16,
                               **kw)) < 1e-5
