"""The port's training path against the reference's, on the CPU at reduced
sizes (float32): ``make_token_dataset``, the train step
(``launch/steps.py::make_train_step``: gradients, clipping, AdamW) on every
arch the port builds from one state carried by ``train_state_from_jax``,
gradient accumulation, checkpoints in the reference's ``.npz`` layout, and
the ``launch/train.py`` CLI.

Tolerances: gradients leaf by leaf within 1e-4 of each leaf's largest
entry (float32 stacks of 2 to 16 layers, sums in other orders: the
reference's prefill-logit tolerance); loss, aux and grad_norm within 1e-5
relative over three steps (xLSTM's 1e-3: ``METRIC_RTOL``); token streams exactly (the same threefry draws);
checkpoints bit for bit."""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.data.synthetic import make_token_dataset as jtokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import checkpoint, configs, optim, random as R, tree  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

from test_torch_transformer import arch_cfgs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 32
# every arch the port builds, reduced; Jamba with and without its experts
TRAINED = [("olmo-1b", {}), ("qwen1.5-4b", {}), ("granite-8b", {}),
           ("jamba-v0.1-52b", {"moe": None}), ("jamba-v0.1-52b", {}),
           ("deepseek-v2-236b", {}), ("arctic-480b", {}), ("xlstm-1.3b", {})]
# xLSTM's three-step metrics: its float32 forward sits ~5e-5 of the
# largest logit from the reference's after 12 layers (each layer's
# gradients within ~1e-6 of a float64 port in both packages,
# tests/test_torch_xlstm.py), and AdamW's normalised first steps turn that
# elementwise noise into updates of full size: grad_norm read 3.3e-5,
# 9.8e-5 and 3.1e-4 apart over the three steps
METRIC_RTOL = {"xlstm-1.3b": 1e-3}


def _err(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


def _batch(vocab, seed=0, n=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (n, S)).astype(np.int32)
    labels[:, -3:] = -1                              # ignored positions
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


def _pair(name, changes, opt=("adamw", (1e-3, 1, 100))):
    """Both packages' model, train step and state: the reference's state
    from its own init, carried to the port."""
    cfg, jcfg = arch_cfgs(name, **changes)
    jm, m = jbuild(jcfg, max_seq=S), build_model(cfg, max_seq=S)
    kind, (lr, warmup, total) = opt
    jo = getattr(jopt, kind)(jopt.warmup_cosine(lr, warmup, total))
    to = getattr(optim, kind)(optim.warmup_cosine(lr, warmup, total))
    jstep, jinit = jsteps.make_train_step(jm, jo)
    tstep, _ = steps.make_train_step(m, to)
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    return cfg, jm, m, jstep, tstep, jstate, tstate


# --------------------------------------------------------------- data --
@pytest.mark.parametrize("seed,n,seq,vocab", [(1, 16, 32, 512),
                                              (5, 3, 100, 50304),
                                              (0, 4, 7, 17), (9, 1, 1, 2)])
def test_token_dataset_is_the_references(seed, n, seq, vocab):
    want = jtokens(jax.random.PRNGKey(seed), n, seq, vocab)
    got = make_token_dataset(R.PRNGKey(seed, "cpu"), n, seq, vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].shape == (n, seq)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------- the step --
@pytest.mark.parametrize("name,changes", TRAINED,
                         ids=[f"{n}{'-no-experts' if c else ''}"
                              for n, c in TRAINED])
def test_train_step_matches_the_reference(name, changes):
    """One state, the same batches: the gradients leaf by leaf, then three
    steps' loss, aux and grad_norm; the step updates the state in place and
    counts it."""
    cfg, jm, m, jstep, tstep, jstate, tstate = _pair(name, changes)
    jb, tb = _batch(cfg.vocab_size)
    (jtot, (jloss, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jm), has_aux=True))(jstate["params"], jb)
    (ttot, steps_loss, taux), tgrads = steps.make_grad_fn(m)(
        tstate["params"], tb)
    assert _err(steps_loss, jloss) < 1e-5 and _err(ttot, jtot) < 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6
    jleaves = jax.tree.leaves(jgrads)
    tleaves = tree.leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    assert all(not p.requires_grad for p in tree.leaves(tstate["params"]))
    for g, w in zip(tleaves, jleaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.abs(np.asarray(w)).max() > 0
        assert _err(g, w) < 1e-4

    jstep = jax.jit(jstep)
    params = tree.leaves(tstate["params"])
    for i in range(3):
        jb, tb = _batch(cfg.vocab_size, seed=i + 1)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        for k in ("loss", "aux", "grad_norm"):
            assert tmet[k].dim() == 0 and tmet[k].dtype == torch.float32
            if k == "aux" and float(jmet[k]) == 0:
                assert float(tmet[k]) == 0
            else:
                assert _err(tmet[k], jmet[k]) < METRIC_RTOL.get(name, 1e-5), \
                    (i, k)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert all(a is b for a, b in zip(tree.leaves(tstate["params"]), params))


def test_default_optimizer_and_init_state_are_the_references():
    """``make_train_step`` without an optimizer: AdamW under
    ``warmup_cosine(3e-4, 100, 10_000)``, its moments float32 zeros, the
    step an int32 0; one step from the reference's state agrees."""
    cfg, jcfg = arch_cfgs("olmo-1b")
    jm, m = jbuild(jcfg, max_seq=S), build_model(cfg, max_seq=S)
    jstep, jinit = jsteps.make_train_step(jm)
    tstep, tinit = steps.make_train_step(m)
    state = tinit(R.PRNGKey(0, "cpu"))
    assert set(state) == {"params", "opt", "step"} and set(state["opt"]) == {"m", "v"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for mom in tree.leaves(state["opt"]):
        assert mom.dtype == torch.float32 and not mom.any()
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for g, w in zip(tree.leaves(state["params"]),
                    jax.tree.leaves(jstate["params"])):
        assert _err(g, w) < 1e-6
    jb, tb = _batch(cfg.vocab_size, seed=4)
    for _ in range(2):
        jstate, jmet = jax.jit(jstep)(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        for k in ("loss", "grad_norm"):
            assert _err(tmet[k], jmet[k]) < 1e-5


def test_gradient_accumulation_matches_full_batch():
    """``accum_steps=2``: the reference's test (tests/test_train_features.py)
    on the port, and the port's accumulated step against the reference's."""
    cfg, jcfg = arch_cfgs("olmo-1b")
    jm, m = jbuild(jcfg, max_seq=S), build_model(cfg, max_seq=S)
    opt = optim.sgd(0.01)
    step1, init = steps.make_train_step(m, opt)
    step2, _ = steps.make_train_step(m, opt, accum_steps=2)
    jstep2, jinit = jsteps.make_train_step(jm, jopt.sgd(0.01), accum_steps=2)
    jstate = jinit(jax.random.PRNGKey(0))
    jb, tb = _batch(cfg.vocab_size, seed=8, n=8)
    s1 = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    s2 = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    s1, m1 = step1(s1, tb)
    s2, m2 = step2(s2, tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)
    _, jm2 = jax.jit(jstep2)(jstate, jb)
    for k in ("loss", "grad_norm"):
        assert _err(m2[k], jm2[k]) < 1e-5


# -------------------------------------------------------- checkpoints --
def _bf16_state():
    """The reference's train state of olmo-1b reduced with bf16 weights
    (float32 moments), after one step so that nothing is zero."""
    cfg, jcfg = arch_cfgs("olmo-1b", dtype=jnp.bfloat16)
    jm = jbuild(jcfg, max_seq=S)
    jstep, jinit = jsteps.make_train_step(jm, jopt.adamw(1e-2))
    jstate, _ = jax.jit(jstep)(jinit(jax.random.PRNGKey(0)),
                               _batch(cfg.vocab_size)[0])
    return cfg, jstate


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_reference_checkpoint_restores_bit_for_bit():
    cfg, jstate = _bf16_state()
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert tree.leaves(want["params"])[0].dtype == torch.bfloat16
    _, init = steps.make_train_step(build_model(cfg, max_seq=S))
    template = init(R.PRNGKey(5, "cpu"))
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, 1, jstate)
        assert checkpoint.latest_step(d) == 1
        got = checkpoint.restore_checkpoint(d, template)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        _same_bits(a, b)


def test_checkpoint_round_trip_is_bit_for_bit():
    cfg, jstate = _bf16_state()
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    doubled = tree.map(lambda t: t * 2, state)
    with tempfile.TemporaryDirectory() as d:
        path = checkpoint.save_checkpoint(d, 7, state)
        assert os.path.basename(path) == "ckpt_00000007.npz"
        with np.load(path) as data:            # the reference's layout
            assert "params::embed::table" in data and "step" in data
            assert data["params::embed::table"].dtype == np.dtype("V2")
        checkpoint.save_checkpoint(d, 9, doubled)
        assert checkpoint.latest_step(d) == 9
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        for step, want in ((None, doubled), (7, state)):
            got = checkpoint.restore_checkpoint(d, state, step=step)
            for a, b in zip(tree.leaves(got), tree.leaves(want)):
                _same_bits(a, b)
        # the reference reads the port's float32 leaves
        jgot = jckpt.restore_checkpoint(d, {"step": jnp.int32(0)}, step=7)
        assert int(jgot["step"]) == int(state["step"])
        bad = dict(state, step=torch.zeros(3, dtype=torch.int32))
        with pytest.raises(ValueError, match="step"):
            checkpoint.restore_checkpoint(d, bad)
        os.remove(os.path.join(d, "latest"))
        assert checkpoint.latest_step(d) == 9
    with tempfile.TemporaryDirectory() as d:
        assert checkpoint.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            checkpoint.restore_checkpoint(d, state)


# ---------------------------------------------------------------- CLI --
def test_train_cli_runs_and_checkpoints():
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "olmo-1b", "--device", "cpu", "--steps", "3", "--batch", "2",
             "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "3"],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        out = proc.stdout
        assert "arch=olmo-1b (reduced=True)" in out and "device=cpu" in out
        # logged at step 0 and at the last step (--log-every 10)
        assert out.count("loss=") == 2 and "step     2" in out
        assert out.rstrip().endswith("done")
        assert checkpoint.latest_step(d) == 3
        cfg = configs.get_arch("olmo-1b").reduced()
        _, init = steps.make_train_step(build_model(cfg, max_seq=32))
        state = checkpoint.restore_checkpoint(d, init(R.PRNGKey(0, "cpu")))
        assert int(state["step"]) == 3
        assert all(torch.isfinite(t).all() for t in tree.leaves(state))


def test_train_cli_without_a_card_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: --device cuda would run")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
