"""The port's selective-SSM scan and Mamba block against the reference's,
on the CPU.

- ``ops.ssm_scan`` (here its plain version, ``ref.py``) against the JAX
  Pallas kernel run in interpret mode and against its oracle, on the
  reference's kernel cases (tests/test_kernels.py) and one decode step
  (S = 1 from a given state), with the inputs drawn with numpy as the
  reference's test draws them: dt = softplus(z) * 0.1, A = -exp(0.3 z).
- ``models/ssm.py`` against ``repro/models/ssm.py`` on Jamba without its
  experts, ``.reduced()`` (float32, d 256, d_inner 512, N 8, chunk 32):
  the weights under the reference's key schedule, train, prefill (output,
  h and the conv state) and decode steps on the same weights and inputs.

Tolerances, and why:
- the scan: 1e-4, the reference's own kernel-against-oracle tolerance
  (float32 in both; the exponentials and the sums over N may differ in the
  last bits);
- init: 1e-6 (``normal`` goes through erfinv, whose ``log1p`` differs in the
  last bit);
- the Mamba block, float32: 1e-4.  The reference's prefill sums the
  recurrence with an associative scan (a tree of products), the port
  step by step, so the two round differently;
- the bfloat16 block: its in/out projections, convolution and gate are
  bf16 products that round at other places in the two frameworks: 2^-5,
  a few bf16 steps of its O(1) outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.ops import ssm_scan as jscan  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import random as R, tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_transformer import JAMBA, arch_cfgs  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# B, S, D, N, with_h0: the reference's kernel cases, then one decode step
CASES = [
    (2, 128, 64, 16, False),
    (1, 64, 256, 8, True),
    (2, 96, 32, 16, False),
    (1, 200, 48, 4, True),
    (4, 1, 96, 16, True),
]
B, T0, T = 2, 8, 16


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **kw)


def _scan_inputs(B, S, D, N, with_h0, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    x = f32(B, S, D)
    dt = (np.logaddexp(f32(B, S, D), 0) * 0.1).astype(np.float32)
    A = -np.exp(f32(D, N) * 0.3).astype(np.float32)
    Bc, Cc = f32(B, S, N), f32(B, S, N)
    h0 = f32(B, D, N) if with_h0 else None
    return x, dt, A, Bc, Cc, h0


# ----------------------------------------------------------------- scan --
@pytest.mark.parametrize("B,S,D,N,with_h0", CASES)
def test_scan_matches_the_pallas_kernel_and_its_oracle(B, S, D, N, with_h0):
    arrays = _scan_inputs(B, S, D, N, with_h0, S * D)
    tx = [None if a is None else torch.as_tensor(a) for a in arrays]
    jx = [None if a is None else jnp.asarray(a) for a in arrays]
    y, h = ops.ssm_scan(*tx)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    ky, kh = jscan(*jx, interpret=True)
    ry, rh = jref(*jx)
    for got, want in ((y, ky), (h, kh), (y, ry), (h, rh)):
        close(got, want, **TOL)


def test_scan_writes_the_state_into_h_out_even_over_h0():
    x, dt, A, Bc, Cc, h0 = (torch.as_tensor(a) for a in
                            _scan_inputs(2, 5, 32, 8, True, 1))
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, h0)
    state = h0.clone()
    y, h = ops.ssm_scan(x, dt, A, Bc, Cc, state, h_out=state)
    assert h is state
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_h, rtol=0, atol=0)


def test_scan_casts_its_inputs_to_float32():
    arrays = _scan_inputs(1, 6, 16, 4, True, 2)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in arrays]
    y, h = ops.ssm_scan(*bf)
    want_y, want_h = ref.ssm_scan_ref(*(t.float() for t in bf))
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


def test_scan_raises_on_devices_other_than_cuda_and_cpu():
    x, dt, A, Bc, Cc, _ = (torch.as_tensor(a) if a is not None else None
                           for a in _scan_inputs(1, 4, 8, 4, False, 3))
    meta = [t.to("meta") for t in (x, dt, A, Bc, Cc)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssm_scan(*meta)


# ---------------------------------------------------------------- mamba --
def test_mamba_init_gives_the_reference_weights():
    cfg, jcfg = arch_cfgs(JAMBA, moe=None)
    jk = jax.random.PRNGKey(4)
    want = jssm.mamba_init(jk, jcfg)
    got = ssm.mamba_init(R.as_key(np.asarray(jk), "cpu"), cfg)
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda _: None, want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        close(g, w, rtol=1e-6, atol=1e-6)
    state = ssm.mamba_state_init(cfg, 3, device="cpu")
    jstate = jssm.mamba_state_init(jcfg, 3)
    for k in ("h", "conv"):
        assert tuple(state[k].shape) == jstate[k].shape
        assert state[k].dtype == torch.float32


def test_mamba_init_keeps_A_log_and_D_in_float32_in_a_bf16_model():
    cfg, jcfg = arch_cfgs(JAMBA, jnp.bfloat16, moe=None)
    jk = jax.random.PRNGKey(5)
    want = jax.tree.map(np.asarray, jssm.mamba_init(jk, jcfg))
    got = ssm.mamba_init(R.as_key(np.asarray(jk), "cpu"), cfg)
    carried = params_from_jax(want, "cpu")
    for name in want:
        for k in want[name] if isinstance(want[name], dict) else [None]:
            w = want[name] if k is None else want[name][k]
            g = got[name] if k is None else got[name][k]
            c = carried[name] if k is None else carried[name][k]
            f32 = name in ("A_log", "D")
            assert g.dtype == c.dtype == (torch.float32 if f32
                                          else torch.bfloat16)
            close(g, w.astype(np.float32), rtol=1e-6, atol=1e-6)
            assert (c.float().numpy() == w.astype(np.float32)).all()


def _mamba_pair(dtype=None):
    cfg, jcfg = arch_cfgs(JAMBA, dtype, moe=None)
    jp = jssm.mamba_init(jax.random.PRNGKey(6), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.param_dtype)
    tx = torch.as_tensor(x).to(cfg.param_dtype)
    return cfg, jcfg, jp, tp, jx, tx


def test_mamba_train_matches_the_reference():
    cfg, jcfg, jp, tp, jx, tx = _mamba_pair()
    want, _ = jssm.mamba_apply(jp, jx, cfg=jcfg, mode="train")
    got, state = ssm.mamba_apply(tp, tx, cfg=cfg, mode="train")
    assert state is None and got.dtype == torch.float32
    close(got, want, **TOL)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_mamba_prefill_and_decode_match_the_reference(dtype):
    """Prefill T0 positions (the output, h and the conv state written into
    the given state in place), then decode the rest one at a time."""
    cfg, jcfg, jp, tp, jx, tx = _mamba_pair(dtype)
    tol = TOL if dtype is None else dict(rtol=2 ** -5, atol=2 ** -5)
    jstate = jssm.mamba_state_init(jcfg, B)
    state = ssm.mamba_state_init(cfg, B, device="cpu")
    views = dict(state)
    want, jstate = jssm.mamba_apply(jp, jx[:, :T0], cfg=jcfg, mode="prefill",
                                    state=jstate)
    got, out = ssm.mamba_apply(tp, tx[:, :T0], cfg=cfg, mode="prefill",
                               state=state)
    assert out is state and all(state[k] is views[k] for k in views)
    close(got, want, **tol)
    for k in ("h", "conv"):
        assert state[k].dtype == torch.float32
        close(state[k], jstate[k], **tol)
    for t in range(T0, T):
        want, jstate = jssm.mamba_apply(jp, jx[:, t:t + 1], cfg=jcfg,
                                        mode="decode", state=jstate)
        got, _ = ssm.mamba_apply(tp, tx[:, t:t + 1], cfg=cfg, mode="decode",
                                 state=state)
        close(got, want, **tol)
    for k in ("h", "conv"):
        assert state[k] is views[k]
        close(state[k], jstate[k], **tol)


def test_mamba_takes_only_whole_chunks_as_the_reference_does():
    cfg, jcfg, jp, tp, *_ = _mamba_pair()
    x = np.zeros((1, 40, cfg.d_model), np.float32)      # chunk 32
    with pytest.raises(AssertionError, match="chunk"):
        jssm.mamba_apply(jp, jnp.asarray(x), cfg=jcfg, mode="train")
    with pytest.raises(ValueError, match="chunk"):
        ssm.mamba_apply(tp, torch.as_tensor(x), cfg=cfg, mode="train")


def test_causal_conv_sums_the_taps_in_the_reference_order():
    """bf16 taps summed from 0 in ascending order, as the reference's
    Python ``sum``, with and without a carried conv state."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)):
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        targs = [torch.as_tensor(a).to(dtype) for a in (x, w, b)]
        jargs = [jnp.asarray(a).astype(jd) for a in (x, w, b)]
        close(ssm._causal_conv(*targs), jssm._causal_conv(*jargs),
              rtol=tol, atol=tol)
        close(ssm._causal_conv(*targs, torch.as_tensor(st)),
              jssm._causal_conv(*jargs, jnp.asarray(st)), rtol=tol, atol=tol)
