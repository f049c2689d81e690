"""The gradients of the port's two kernels' functions on the CPU: the
plain backward versions (``flash_attention_bwd_ref``, ``ssm_scan_bwd_ref``)
against ``jax.vjp`` of the reference's oracles on the same numpy inputs,
and the port's autograd functions (the backward kernels' wrappers, which
on a CPU tensor run the plain backward) against torch autograd of the
plain forward.

Tolerances: flash, within 1e-5 of each gradient's largest entry (float32
sums of the same products in another order); the scan, within 1e-4 (the
reference's own kernel-against-oracle tolerance: a recurrence of
exponentials summed step by step in both, in other orders)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jflash)
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jscan  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the reference's kernel sweep (tests/test_kernels.py), at a quarter of
# its lengths where they exceed 128 (the plain versions are O(S^2) here)
FA_CASES = [
    # B, S, H, KV, hd, causal, window
    (2, 64, 4, 2, 64, True, None),
    (1, 128, 4, 4, 128, True, 32),
    (2, 128, 8, 1, 32, False, None),
    (1, 75, 2, 2, 80, True, None),
    (1, 64, 4, 4, 128, True, 16),
]
# the reference's scan cases, each with and without h0
SSM_CASES = [(2, 128, 64, 16), (1, 64, 256, 8), (2, 96, 32, 16),
             (1, 200, 48, 4)]


def _err(got, want):
    """max |got - want| over max(1e-30, max |want|)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


def _fa_inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FA_CASES)
def test_flash_attention_bwd_ref_matches_the_reference_vjp(
        B, S, H, KV, hd, causal, window):
    q, k, v, do = _fa_inputs(B, S, H, KV, hd, S + hd)
    o, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal,
                                            window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = fa_ref.flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    to = fa_ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert _err(to, o) < 1e-5
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, tdo, lse,
                                         causal=causal, window=window)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == torch.float32
        assert _err(g, w) < 1e-5


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (2, 64, 600, 4, 4, 64, False), (1, 160, 160, 4, 2, 128, True)])
@pytest.mark.parametrize("spread", [0.01, 0.05])
def test_flash_attention_bwd_ref_holds_when_keys_are_alike(
        B, Sq, Sk, H, KV, hd, causal, spread):
    """Keys a few percent apart (a deep encoder's frames, as Whisper's
    cross-attention reads them) spread each row's attention evenly, so dS
    = P (dP - D) is a difference of near-equal numbers.  bf16 inputs; the
    plain backward against torch autograd through the forward in float32
    on the same inputs, within 2^-7 of each gradient's largest entry (the
    results are rounded to bf16).  D taken from the bf16 output, as
    FlashAttention-2 takes it, misses by ~9e-2 and ~0.4 of dq's largest
    entry at these spreads (tools/flash_bwd_accuracy.py cpu)."""
    g = torch.Generator().manual_seed(Sk + Sq)
    q = torch.randn(B, Sq, H, hd, generator=g).bfloat16()
    k = (torch.randn(1, 1, KV, hd, generator=g)
         + spread * torch.randn(B, Sk, KV, hd, generator=g)).bfloat16()
    v = torch.randn(B, Sk, KV, hd, generator=g).bfloat16()
    do = torch.randn(B, Sq, H, hd, generator=g).bfloat16()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = fa_ref.flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do.float())
    lse = fa_ref.flash_attention_lse_ref(q, k, causal=causal)
    got = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, causal=causal)
    for gr, w in zip(got, want):
        assert gr.dtype == torch.bfloat16
        assert _err(gr.float(), w.numpy()) < 2 ** -7


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FA_CASES)
def test_flash_attention_function_equals_autograd_of_the_plain_forward(
        B, S, H, KV, hd, causal, window):
    """On CPU tensors that require a gradient, ``ops.flash_attention`` is
    the autograd function (its backward the plain gradient): the same
    output and, within 1e-5, the same gradients as torch autograd through
    ``flash_attention_ref``."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _fa_inputs(B, S, H, KV, hd, 7 * S + hd))
    kw = dict(causal=causal, window=window)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    oa = fa_ops.flash_attention(*a, **kw)
    assert oa.grad_fn is not None and "FlashAttention" in type(oa.grad_fn).__name__
    ob = fa_ref.flash_attention_ref(*b, **kw)
    assert torch.equal(oa, ob)
    for ga, gb in zip(torch.autograd.grad(oa, a, do),
                      torch.autograd.grad(ob, b, do)):
        assert _err(ga, gb.numpy()) < 1e-5


def test_flash_attention_gradient_refuses_what_training_does_not_call():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() if i < 3 else None
                  for i, a in enumerate(_fa_inputs(1, 8, 2, 2, 32, 1)))
    for kw in (dict(q_offset=3), dict(kv_len=5)):
        with pytest.raises(NotImplementedError, match="q_offset 0"):
            fa_ops.flash_attention(q, k, v, causal=True, **kw)
    with torch.no_grad():            # no gradient: the forward takes both
        fa_ops.flash_attention(q, k, v, causal=True, q_offset=3, kv_len=5)


def _ssm_inputs(B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.normal(size=(B, S, D)).astype(f32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.1).astype(f32)
    A = (-np.exp(rng.normal(size=(D, N)) * 0.3)).astype(f32)
    Bc = rng.normal(size=(B, S, N)).astype(f32)
    Cc = rng.normal(size=(B, S, N)).astype(f32)
    h0 = rng.normal(size=(B, D, N)).astype(f32)
    dy = rng.normal(size=(B, S, D)).astype(f32)
    dh = rng.normal(size=(B, D, N)).astype(f32)
    return x, dt, A, Bc, Cc, h0, dy, dh


@pytest.mark.parametrize("B,S,D,N", SSM_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_bwd_ref_matches_the_reference_vjp(B, S, D, N, with_h0,
                                                    with_dh):
    x, dt, A, Bc, Cc, h0, dy, dh = _ssm_inputs(B, S, D, N, S * D + N)
    ins = [x, dt, A, Bc, Cc] + ([h0] if with_h0 else [])
    dh = dh if with_dh else np.zeros_like(h0)
    _, vjp = jax.vjp(lambda *a: jscan(*a), *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    t = [torch.from_numpy(a) for a in ins]
    got = ssm_ref.ssm_scan_bwd_ref(*t[:5], t[5] if with_h0 else None,
                                   torch.from_numpy(dy),
                                   torch.from_numpy(dh) if with_dh else None)
    assert (got[5] is None) == (not with_h0)
    for g, w in zip([g for g in got if g is not None], want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _err(g, w) < 1e-4


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_function_equals_autograd_of_the_plain_forward(with_h0):
    """On CPU tensors that require a gradient, ``ops.ssm_scan`` is the
    autograd function (its backward the plain gradient): the same outputs
    and, within 1e-4, the same gradients as torch autograd through
    ``ssm_scan_ref``, with cotangents for y and for the last state."""
    x, dt, A, Bc, Cc, h0, dy, dh = (torch.from_numpy(a) for a in
                                    _ssm_inputs(2, 40, 24, 8, 11))
    ins = [x, dt, A, Bc, Cc] + ([h0] if with_h0 else [])
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    ya, ha = ssm_ops.ssm_scan(*a)
    assert "SsmScan" in type(ya.grad_fn).__name__
    yb, hb = ssm_ref.ssm_scan_ref(*b)
    assert torch.equal(ya, yb) and torch.equal(ha, hb)
    ga = torch.autograd.grad((ya * dy).sum() + (ha * dh).sum(), a)
    gb = torch.autograd.grad((yb * dy).sum() + (hb * dh).sum(), b)
    for g, w in zip(ga, gb):
        assert _err(g, w.numpy()) < 1e-4
    # without a cotangent for the state (training discards it)
    ya, _ = ssm_ops.ssm_scan(*a)
    yb, _ = ssm_ref.ssm_scan_ref(*b)
    for g, w in zip(torch.autograd.grad(ya, a, dy),
                    torch.autograd.grad(yb, b, dy)):
        assert _err(g, w.numpy()) < 1e-4


def test_ssm_scan_gradient_refuses_an_in_place_state():
    x, dt, A, Bc, Cc, h0, _, _ = (torch.from_numpy(a) for a in
                                  _ssm_inputs(1, 4, 8, 4, 2))
    with pytest.raises(NotImplementedError, match="h_out"):
        ssm_ops.ssm_scan(x.requires_grad_(), dt, A, Bc, Cc, h0, h_out=h0)


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.flash_attention.flash_attention_bwd",
    "repro_torch.kernels.ssm_scan.ssm_scan_bwd"])
def test_backward_kernel_modules_import_without_nvcc(module):
    """The backward kernels build lazily, as the forward ones: importing
    their modules compiles nothing and needs no CUDA toolkit."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(ROOT / "no-cuda-here"),
               PYTHONPATH=str(ROOT / "src"))
    code = (f"import {module} as k, sys\n"
            "assert not k._lib and k.launches == 0\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
