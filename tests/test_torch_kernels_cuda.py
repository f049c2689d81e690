"""The CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the reference (the machine with the
card has no JAX), and skip where torch sees no CUDA device.  Run them
there without the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as R, tree  # noqa: E402
from repro_torch.kernels.bwo_evolve import bwo_evolve as kernel_mod  # noqa: E402
from repro_torch.kernels.bwo_evolve import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as fa_kernel, flash_attention_bwd as fa_bwd,
    ops as fa_ops, ref as fa_ref)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ops as ssm_ops, ref as ssm_ref, ssm_scan as ssm_kernel,
    ssm_scan_bwd as ssm_bwd)
from repro_torch.kernels.threefry import (  # noqa: E402
    ops as tf_ops, ref as tf_ref, threefry as tf_kernel)

GRID = [(4, 128), (8, 100), (16, 1000), (6, 4097)]
DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 2e-2)}

# B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len: the reference's
# kernel sweep (tests/test_kernels.py), decode against a cache (scalar and
# per-row lengths, windowed), chunked prefill, and the OLMo-1B shapes
FA_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, 0, None),
    (1, 512, 512, 4, 4, 128, True, 128, 0, None),
    (2, 128, 128, 8, 1, 32, False, None, 0, None),
    (1, 300, 300, 2, 2, 80, True, None, 0, None),
    (1, 256, 256, 4, 4, 128, True, 64, 0, None),
    (3, 1, 40, 4, 2, 64, False, None, 0, 23),
    (3, 1, 40, 4, 2, 64, False, None, 0, [23, 40, 1]),
    (2, 1, 100, 4, 4, 128, True, 16, 70, None),
    (2, 24, 90, 4, 2, 80, True, None, 60, 84),
    (4, 1024, 1024, 16, 16, 128, True, None, 0, None),
    (4, 1, 1056, 16, 16, 128, False, None, 0, 1040),
]
# f32: sums in another order than the plain version's cuBLAS products;
# bf16: both round the same fp32 result to bf16, which may differ by one
# bf16 step (2^-8 relative)
FA_DTYPES = {"float32": (torch.float32, torch.float32, 2e-5),
             "bfloat16": (torch.bfloat16, torch.bfloat16, 3e-2),
             "float32-bf16-cache": (torch.float32, torch.bfloat16, 2e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("P,D", GRID + [(6, 2_465_322)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain_version(P, D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = DTYPES[dtype]
    key = R.PRNGKey(P * 1000 + D, "cuda")
    pop = R.normal(key, (P, D)).to(tdt)
    fit = R.uniform(R.split(key)[1], (P,))
    before = kernel_mod.launches
    got = ops.bwo_evolve(pop, fit, key)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    want = ops.bwo_evolve_reference(pop, fit, key)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_vmapped_generation_is_one_launch_for_every_client():
    """Under torch.func.vmap over C = 10 clients of P = 6 rows, a BWO
    generation is one launch over the 60 rows, equal bit for bit to a loop
    of one launch a client; past the grid's rows it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    C, P, D = 10, 6, 4097
    keys = R.split(R.PRNGKey(77, "cuda"), C)
    pops = torch.stack([R.normal(k, (P, D)) for k in keys])
    fits = torch.stack([R.uniform(R.split(k)[1], (P,)) for k in keys])
    before = kernel_mod.launches
    got = torch.func.vmap(ops.bwo_evolve)(pops, fits, keys)
    torch.cuda.synchronize()
    assert kernel_mod.launches == before + 1
    want = torch.stack([ops.bwo_evolve(pops[c], fits[c], keys[c])
                        for c in range(C)])
    assert kernel_mod.launches == before + 1 + C
    assert torch.equal(got, want)
    big = kernel_mod.MAX_ROWS // P + 1
    with pytest.raises(ValueError, match="grid"):
        torch.func.vmap(ops.bwo_evolve)(
            pops[:1, :, :8].expand(big, P, 8).contiguous(),
            fits[:1].expand(big, P).contiguous(),
            keys[:1].expand(big, 2).contiguous())


def _qkv(B, Sq, Sk, H, KV, hd, qdt, kvdt, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g).to("cuda", qdt)
    k = torch.randn(B, Sk, KV, hd, generator=g).to("cuda", kvdt)
    v = torch.randn(B, Sk, KV, hd, generator=g).to("cuda", kvdt)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset,kv_len",
                         FA_CASES)
@pytest.mark.parametrize("dtype", list(FA_DTYPES))
def test_flash_attention_kernel_matches_plain_version(
        B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qdt, kvdt, tol = FA_DTYPES[dtype]
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, qdt, kvdt, Sq * 1000 + Sk + hd)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    before = fa_kernel.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1
    assert got.dtype == qdt and got.shape == q.shape
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_reads_strided_views(dtype):
    """A window sliced out of a cache, and rows whose stride rules out
    16-byte loads: the kernel reads both through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    qdt, kvdt, tol = FA_DTYPES[dtype]
    q, k, v = _qkv(2, 5, 80, 4, 2, 64, qdt, kvdt, 11)
    k_odd = torch.zeros(2, 80, 2, 65, dtype=kvdt, device="cuda")[..., :64]
    k_odd.copy_(k)
    for kk, vv in ((k[:, 17:49], v[:, 17:49]), (k_odd, v)):
        got = fa_ops.flash_attention(q, kk, vv, causal=True, q_offset=20)
        want = fa_ref.flash_attention_ref(q, kk, vv, causal=True, q_offset=20)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# The bf16 routes.  B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len.
# Tensor cores: hd 64 and 128, rep 1, 2, 4 and 8, Sq 17 and 40 (a tile
# whose second warpgroup has no rows), 64, 300 (ragged) and 1024, causal
# with q_offset (chunked prefill against a longer K/V), a window, per-row
# lengths.  Tolerance 3e-2, FA_DTYPES' bf16 one, and _close_to_own_size.
TC_CASES = [
    (2, 17, 40, 4, 2, 64, True, None, 23, None),
    (3, 40, 200, 8, 4, 128, True, 96, 160, [200, 190, 170]),
    (2, 64, 64, 4, 4, 64, True, None, 0, None),
    (2, 64, 200, 8, 1, 128, True, None, 136, None),
    (1, 300, 300, 4, 2, 128, True, None, 0, None),
    (1, 300, 300, 8, 2, 64, False, None, 0, None),
    (2, 1024, 1024, 8, 1, 64, True, None, 0, None),
    (1, 1024, 1024, 16, 4, 128, True, 256, 0, None),
    (2, 300, 400, 4, 4, 128, True, 64, 100, [380, 340]),
    (4, 1024, 1024, 32, 8, 128, True, None, 0, None),
    # Whisper-medium: the encoder (1500 frames, no multiple of the 128-row
    # tile, bidirectional) and cross-attention at prefill (32 queries
    # against 1500 keys); LLaVA-NeXT's prefill (2880 image rows + 32 text)
    (4, 1500, 1500, 16, 16, 64, False, None, 0, None),
    (4, 32, 1500, 16, 16, 64, False, None, 0, None),
    (1, 2912, 2912, 32, 8, 128, True, None, 0, None),
]
# Split-K: (B,) lengths with rows shorter than one chunk and rows equal to
# Sk, 1 to 16 queries, rep up to 8, windows with q_offset
SPLIT_CASES = [
    (3, 1, 40, 4, 2, 64, False, None, 0, [23, 40, 1]),
    (4, 1, 1056, 16, 16, 128, False, None, 0, [1056, 30, 1040, 64]),
    (4, 1, 1056, 32, 8, 128, False, None, 0, [1025, 1056, 7, 700]),
    (2, 1, 100, 4, 4, 128, True, 16, 70, None),
    (2, 5, 300, 8, 2, 64, True, None, 290, [300, 40]),
    (2, 16, 200, 16, 2, 128, True, 50, 150, None),
    (1, 9, 3000, 8, 1, 64, True, 1000, 2990, None),
    # Whisper's cross decode over the 1500-frame cross cache (no kv_len);
    # LLaVA-NeXT's decode over a 2944-position cache
    (4, 1, 1500, 16, 16, 64, False, None, 0, None),
    (4, 1, 2944, 32, 8, 128, False, None, 0, 2913),
]


def _close_to_own_size(got, want):
    """bf16 outputs held to their own size as well as to 3e-2, which is
    about a typical entry where a row spreads over ~1500 keys: each query
    row's largest error within two bf16 steps of its largest entry, the
    error's RMS within 2^-7 of the output's."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert (err.amax(-1) <= 2 ** -6 * want.abs().amax(-1)).all(), \
        (err.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max().item()
    assert err.pow(2).mean().sqrt() <= 2 ** -7 * want.pow(2).mean().sqrt()


def _lens(kv_len):
    if isinstance(kv_len, list):
        return torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return kv_len


def _run_route(case, route, seed):
    B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len = case
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, torch.bfloat16, seed)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=_lens(kv_len))
    before = dict(fa_kernel.route_launches)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {r: fa_kernel.route_launches[r] - before[r]
            for r in fa_kernel.ROUTES} == {r: int(r == route)
                                           for r in fa_kernel.ROUTES}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    _close_to_own_size(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_attention_tensor_core_route(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _run_route(case, "tensor_core", sum(case[:6]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_flash_attention_split_k_route(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _run_route(case, "split_k", sum(case[:6]))


@pytest.mark.cuda
def test_flash_attention_split_k_reads_the_windowed_decode_views():
    """The sliding-window decode passes ``_slice_at``'s windows: a narrowed
    view of the cache (one start) and a gather (per-row starts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.models.attention import _slice_at
    q, k, v = _qkv(3, 1, 96, 8, 2, 128, torch.bfloat16, torch.bfloat16, 17)
    win = 24
    for start, kv_len in ((50, win), (torch.tensor([0, 40, 72], device="cuda"),
                                      torch.tensor([10, 24, 24], device="cuda",
                                                   dtype=torch.int32))):
        kk, vv = _slice_at(k, start, win), _slice_at(v, start, win)
        before = fa_kernel.route_launches["split_k"]
        got = fa_ops.flash_attention(q, kk, vv, causal=False, kv_len=kv_len)
        torch.cuda.synchronize()
        assert fa_kernel.route_launches["split_k"] == before + 1
        want = fa_ref.flash_attention_ref(q, kk, vv, causal=False,
                                          kv_len=kv_len)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        _close_to_own_size(got, want)


@pytest.mark.cuda
def test_flash_attention_routes_the_other_calls_to_the_cuda_cores():
    """float32 at hd 128, float32 decode, float32 q on a bf16 cache, hd 32
    and 80, and bf16 prefill whose strides TMA cannot read stay on the
    CUDA-core kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    bf = torch.bfloat16
    q, k, v = _qkv(1, 40, 40, 2, 2, 64, bf, bf, 3)
    k_odd = torch.zeros(1, 40, 2, 65, dtype=bf, device="cuda")[..., :64]
    k_odd.copy_(k)
    f32 = torch.float32
    calls = [(q, k_odd, v), (q.float(), k, v),
             _qkv(1, 40, 40, 2, 2, 128, f32, f32, 128),
             _qkv(1, 16, 40, 2, 2, 64, f32, f32, 16)] + [
        _qkv(1, 40, 40, 2, 2, hd, bf, bf, hd) for hd in (32, 80)]
    for qq, kk, vv in calls:
        before = dict(fa_kernel.route_launches)
        got = fa_ops.flash_attention(qq, kk, vv, causal=True)
        torch.cuda.synchronize()
        assert fa_kernel.route_launches["cuda_core"] == before["cuda_core"] + 1
        assert fa_kernel.route_launches["tensor_core"] == before["tensor_core"]
        tol = 3e-2 if qq.dtype == bf else 2e-5
        want = fa_ref.flash_attention_ref(qq, kk, vv, causal=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# The 3xTF32 route: float32 q and K/V at hd 64, more than 16 queries,
# strides TMA can read.  B, Sq, Sk, H, KV, hd, causal, window, q_offset,
# kv_len: Sq and Sk of 17, 40, 200 and 1500 (no multiple of the 128-query
# or 64-key tiles), causal with q_offset, windows, an int and a (B,)
# kv_len, rep 1 to 8, fewer and more queries than keys, Whisper-medium's
# encoder and cross prefill, and the float32 prefill that took the
# CUDA-core route before this one.  Tolerance FA_DTYPES' float32 2e-5.
TF32_CASES = [
    (2, 17, 200, 4, 2, 64, True, None, 183, None),
    (2, 200, 200, 4, 4, 64, True, None, 0, None),
    (1, 200, 1500, 8, 1, 64, False, None, 0, 1234),
    (3, 40, 200, 8, 4, 64, True, 96, 160, [200, 190, 170]),
    (2, 300, 400, 4, 4, 64, True, 64, 100, [380, 340]),
    (1, 1500, 1500, 8, 8, 64, True, 256, 0, None),
    (2, 1500, 17, 4, 2, 64, False, None, 0, None),
    (4, 1500, 1500, 16, 16, 64, False, None, 0, None),
    (4, 32, 1500, 16, 16, 64, False, None, 0, None),
    (1, 40, 40, 2, 2, 64, True, None, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF32_CASES)
def test_flash_attention_tf32x3_route(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len = case
    qdt, kvdt, tol = FA_DTYPES["float32"]
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, qdt, kvdt, sum(case[:6]))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=_lens(kv_len))
    before = dict(fa_kernel.route_launches)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {r: fa_kernel.route_launches[r] - before[r]
            for r in fa_kernel.ROUTES} == {r: int(r == "tf32x3")
                                           for r in fa_kernel.ROUTES}
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# B, S, D, N, with_h0: the reference's kernel cases (tests/test_kernels.py),
# one decode step, ragged channel tiles, and Jamba's prefill and decode;
# then the kernel's edges: D neither a multiple of the 128-channel block
# nor of 4 (so x and dt come in by 4-byte copies), S of 1 and 3 and a
# length that is no multiple of the 32-step tile and shorter than the
# 3-tile ring, one batch row at Jamba's width, and each N at a ragged D
SSM_CASES = [
    (2, 128, 64, 16, False), (1, 64, 256, 8, True), (2, 96, 32, 16, False),
    (1, 200, 48, 4, True), (4, 1, 8192, 16, True), (3, 77, 40, 8, True),
    (4, 1024, 8192, 16, False),
    (2, 100, 33, 16, True), (3, 1, 33, 8, True), (2, 3, 200, 16, False),
    (2, 77, 130, 16, True), (1, 256, 8192, 16, True),
    (2, 50, 37, 4, True), (2, 50, 129, 8, False), (2, 65, 255, 16, True),
]


def _ssm_inputs(B, S, D, N, with_h0, seed, mamba_A=False):
    """As the reference's test draws them: dt = softplus(z) * 0.1 and
    A = -exp(0.3 z); or A = -(1..N), the mamba initialisation."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to("cuda")

    x = normal(B, S, D)
    dt = torch.nn.functional.softplus(normal(B, S, D)) * 0.1
    A = (-torch.arange(1, N + 1, dtype=torch.float32, device="cuda")
         .repeat(D, 1) if mamba_A else -torch.exp(normal(D, N) * 0.3))
    Bc, Cc = normal(B, S, N), normal(B, S, N)
    h0 = normal(B, D, N) if with_h0 else None
    return x, dt, A, Bc, Cc, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,with_h0", SSM_CASES)
@pytest.mark.parametrize("mamba_A", [False, True])
def test_ssm_scan_kernel_matches_plain_version(B, S, D, N, with_h0, mamba_A):
    """Tolerance 1e-4 (the reference's own kernel-against-oracle one),
    relative to max |y| (and max |h|): exponentials and sums over N may
    differ in the last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(B, S, D, N, with_h0, S * 1000 + D, mamba_A)
    before = ssm_kernel.launches
    y, h = ssm_ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    want_y, want_h = ssm_ref.ssm_scan_ref(*args)
    for got, want in ((y, want_y), (h, want_h)):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 70])
def test_ssm_scan_kernel_updates_the_state_in_place(S):
    """h_out aliased to h0, as decode passes the cached state: every
    element of h0 is read before it is overwritten."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, dt, A, Bc, Cc, h0 = _ssm_inputs(4, S, 8192, 16, True, 5)
    want_y, want_h = ssm_ref.ssm_scan_ref(x, dt, A, Bc, Cc, h0)
    state = h0.clone()
    y, h = ssm_ops.ssm_scan(x, dt, A, Bc, Cc, state, h_out=state)
    torch.cuda.synchronize()
    assert h is state
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, want_h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssm_scan_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, dt, A, Bc, Cc, _ = _ssm_inputs(1, 4, 32, 16, False, 6)
    before = ssm_kernel.launches
    with pytest.raises(ValueError, match="state dim"):
        ssm_ops.ssm_scan(x, dt, A[:, :12], Bc[..., :12], Cc[..., :12])
    with pytest.raises(TypeError, match="float32"):
        ssm_kernel.ssm_scan_cuda(x.double(), dt, A, Bc, Cc)
    with pytest.raises(ValueError, match="h_out"):
        ssm_ops.ssm_scan(x, dt, A, Bc, Cc, h_out=torch.empty(1, 32, 8,
                                                              device="cuda"))
    assert ssm_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_kernel_takes_no_steps(with_h0):
    """S = 0: y is empty and h is h0 (zeros without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(2, 0, 40, 8, with_h0, 29)
    y, h = ssm_ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 40)
    want = args[5] if with_h0 else torch.zeros(2, 40, 8, device="cuda")
    assert torch.equal(h, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 70])
def test_ssm_scan_kernel_takes_unaligned_pointers(S):
    """Every input a view one float into its storage, so no pointer is
    16-byte aligned: the kernel takes its 4-byte copies and loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(2, S, 64, 16, True, 17 + S)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda")
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    moved = [shifted(t) for t in args]
    y, h = ssm_ops.ssm_scan(*moved)
    torch.cuda.synchronize()
    want_y, want_h = ssm_ref.ssm_scan_ref(*args)
    for got, want in ((y, want_y), (h, want_h)):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,with_h0", [
    (4, 1024, 8192, 16, False), (4, 1, 8192, 16, True), (2, 77, 33, 8, True)])
def test_ssm_scan_kernel_is_deterministic(B, S, D, N, with_h0):
    """Two launches on the same inputs give the same bits: no atomics, and
    every sum is taken in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(B, S, D, N, with_h0, 23)
    y1, h1 = ssm_ops.ssm_scan(*args)
    y2, h2 = ssm_ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


# ------------------------------------------ fused blocks as CUDA graphs --
# the narrow paper CNN on the card, 3 clients, pop 3, 2 generations, 1
# local epoch: each round launches bwo_evolve twice (once a generation for
# every client)
FL_SMALL = dict(n_clients=3, n_train=90, n_test=30, mh_pop=3,
                mh_generations=2, local_epochs=1, bwo_kernel=True,
                device="cuda", tau=1.01)


def _fl_server(rounds_per_dispatch, pipeline="auto", task=None):
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core import FLConfig, build_experiment
    from repro_torch.data.synthetic import cnn_task
    task = task or cnn_task(CNNConfig(conv1_filters=4, conv2_filters=8,
                                      dense_hidden=16))
    exp = build_experiment(FLConfig(rounds_per_dispatch=rounds_per_dispatch,
                                    pipeline_blocks=pipeline, **FL_SMALL),
                           task=task)
    assert exp.server.engine == "batched"
    return exp.server, exp.eval_data


def _assert_rounds_close(got, want):
    """The same winners, scores within 1e-4 relative: phase 6 of
    chip_smoke.py's bound at narrow width (cuDNN's grouped weight gradient
    sums with atomics, so two runs of one program may differ in the last
    bits)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["best_client"] == w["best_client"]
        torch.testing.assert_close(torch.tensor(g["scores"]),
                                   torch.tensor(w["scores"]), rtol=1e-4,
                                   atol=0)


@pytest.mark.cuda
def test_graphed_block_matches_eager_rounds_and_counts_replays():
    """A block of 3 rounds, one replay of its captured graph, against 3
    eager ``run_round`` calls from the same start; the launch counter
    counts each replay's launches (and the warm-up round's), and the
    graph holds none of its own beyond that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    eager, _ = _fl_server(1)
    fused, teval = _fl_server(3)
    want = [eager.run_round() for _ in range(3)]
    before = kernel_mod.launches
    got = fused.run_block(3, eval_data=teval, eval_every=1)
    torch.cuda.synchronize()
    engine = fused._engine
    (graph,) = engine.graphs.values()
    per_round = FL_SMALL["mh_generations"]
    assert graph.launches == 3 * per_round and graph.replays == 1
    assert engine.warmup_launches == per_round
    assert kernel_mod.launches - before == 3 * per_round + per_round
    _assert_rounds_close(got, want)
    assert all("eval_loss" in i for i in got)
    for a, b in zip(tree.leaves(eager.global_params),
                    tree.leaves(fused.global_params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert fused.meter.summary() == eager.meter.summary()


@pytest.mark.cuda
def test_each_block_shape_is_captured_once():
    """Four blocks of one shape and eval cadence 1: one capture, four
    replays, one warm-up; a block of another length is a second graph
    with no second warm-up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    server, teval = _fl_server(2)
    for _ in range(4):
        server.run_block(2, eval_data=teval, eval_every=1)
    engine = server._engine
    assert [g.replays for g in engine.graphs.values()] == [4]
    server.run_block(1, eval_data=teval, eval_every=1)
    assert sorted(g.replays for g in engine.graphs.values()) == [1, 4]
    assert engine.warmup_launches == FL_SMALL["mh_generations"]
    assert server.rounds_completed == 9


@pytest.mark.cuda
def test_block_logs_survive_the_next_replay():
    """Block k+1 is dispatched before block k is finished (the pipeline's
    order); block k's infos must still be block k's, as a serial twin
    shows, and not the values the next replay wrote into the graph's
    static outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    serial, teval = _fl_server(2)
    piped, _ = _fl_server(2)
    want = [serial.run_block(2, eval_data=teval, eval_every=1)
            for _ in range(2)]
    pending = [piped.dispatch_block(2, teval, 1) for _ in range(2)]
    got = [piped.finish_block(p) for p in pending]
    for g, w in zip(got, want):
        _assert_rounds_close(g, w)
    assert got[0][0]["scores"] != got[1][0]["scores"]
    res = piped.run_pipelined(4, eval_data=teval, eval_every=1)
    assert res.kept == 4 and piped.meter.timing_summary()["blocks"] == 4


@pytest.mark.cuda
def test_a_capture_that_syncs_raises():
    """A loss that builds a tensor from a host scalar (a copy from
    pageable memory, then a sync) cannot be captured: the block raises on
    the card, and nothing runs it eagerly instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.data.synthetic import cnn_task
    base = cnn_task(CNNConfig(conv1_filters=4, conv2_filters=8,
                              dense_hidden=16))

    def loss_fn(params, batch):
        loss, acc = base.loss_fn(params, batch)
        return loss + torch.tensor(0.0, device=loss.device), acc

    server, teval = _fl_server(2, task=base._replace(loss_fn=loss_fn))
    server.run_round()                      # eager: the copy is allowed
    with pytest.raises(RuntimeError):
        server.run_block(2, eval_data=teval, eval_every=1)
    assert server._engine.graphs == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 64])
def test_moe_layer_on_the_card_matches_the_cpu_route(S, dtype):
    """The MoE layer (no kernel of its own: cuBLAS products and an
    ``index_add_`` dispatch) on the card against the same layer on the
    CPU: the same experts and positions, and outputs within 1e-5 (float32,
    TF32 off) or two bf16 steps of the largest (bfloat16: at most one kept
    pair lands in each dispatch row, so the scatter is exact, and the
    products round in other places)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = get_arch("deepseek-v2-236b").reduced()
    cfg = dataclasses.replace(cfg, param_dtype=getattr(torch, dtype))
    p = moe.moe_init(R.PRNGKey(S, "cpu"), cfg)
    x = R.normal(R.PRNGKey(S + 1, "cpu"), (3, S, cfg.d_model)).to(cfg.param_dtype)
    y, aux = moe.moe_apply(p, x, cfg)
    pc = tree.map(lambda t: t.cuda(), p)
    yc, auxc = moe.moe_apply(pc, x.cuda(), cfg)
    rt, rtc = moe.route(p, x, cfg), moe.route(pc, x.cuda(), cfg)
    assert torch.equal(rt.eidx, rtc.eidx.cpu()) and torch.equal(rt.pos, rtc.pos.cpu())
    tol = 1e-5 if dtype == "float32" else y.float().abs().max().item() * 2 ** -6
    torch.testing.assert_close(yc.cpu().float(), y.float(), rtol=0, atol=tol)
    torch.testing.assert_close(auxc.cpu(), aux, rtol=1e-5, atol=1e-6)


# The backward kernels.  flash: B, S, H, KV, hd, causal, window (queries
# from position 0 against every key, as training calls it): the
# reference's kernel sweep, then OLMo-1B's and Jamba's train shapes.
# Tolerance, of the largest entry of each gradient: float32 1e-4 (fp32
# sums in another order than the plain version's, through exp); bf16 2^-7
# (both round one fp32 result to bf16, a step of 2^-8 at the largest).
FA_BWD_CASES = [
    (2, 256, 4, 2, 64, True, None), (1, 512, 4, 4, 128, True, 128),
    (2, 128, 8, 1, 32, False, None), (1, 300, 2, 2, 80, True, None),
    (1, 256, 4, 4, 128, True, 64),
    (4, 1024, 16, 16, 128, True, None), (4, 1024, 32, 8, 128, True, None),
]
FA_BWD_TOL = {"float32": (torch.float32, 1e-4),
              "bfloat16": (torch.bfloat16, 2 ** -7)}


def _close_to_largest(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", list(FA_BWD_TOL))
def test_flash_attention_backward_kernel_matches_plain_version(
        B, S, H, KV, hd, causal, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = FA_BWD_TOL[dtype]
    q, k, v = _qkv(B, S, S, H, KV, hd, tdt, tdt, S + hd)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(hd)
                     ).to("cuda", tdt)
    kw = dict(causal=causal, window=window)
    before = fa_bwd.launches
    got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert fa_bwd.launches == before + 1
    lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
    for g, w in zip(got, want):
        _close_to_largest(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FA_BWD_TOL))
def test_flash_attention_gradient_goes_through_both_kernels(dtype,
                                                            monkeypatch):
    """With inputs that require a gradient, ``ops.flash_attention`` runs the
    forward kernel and its backward runs the backward kernel, never the
    plain gradient; without, it launches the forward alone, as serving
    does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = FA_BWD_TOL[dtype]
    q, k, v = _qkv(2, 200, 200, 8, 2, 64, tdt, tdt, 41)

    def refused(*a, **kw):
        raise AssertionError("the plain gradient ran on the card")

    monkeypatch.setattr(fa_ref, "flash_attention_bwd_ref", refused)
    before = (fa_kernel.launches, fa_bwd.launches)
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v, causal=True, window=50)
    assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 1, before[1])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa_ops.flash_attention(*leaves, causal=True, window=50)
    do = torch.randn_like(o)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fa_kernel.launches, fa_bwd.launches) == (before[0] + 2,
                                                     before[1] + 1)
    monkeypatch.undo()
    lse = fa_ref.flash_attention_lse_ref(q, k, causal=True, window=50)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, causal=True,
                                          window=50)
    for g, w in zip(grads, want):
        _close_to_largest(g, w, tol)


# The tensor-core route of the backward (bf16, hd 64 and 128): ragged
# sequences (not a multiple of the 64- and 128-row tiles), windows, causal
# or not, rep 1, 4 and 8, B 1 to 4.  B, S, H, KV, hd, causal, window.
FA_BWD_TC_CASES = [
    (1, 200, 4, 4, 64, True, None), (2, 1000, 8, 2, 128, True, None),
    (3, 77, 8, 1, 64, False, None), (4, 200, 4, 1, 128, True, 50),
    (2, 333, 8, 8, 128, False, 100), (1, 1000, 16, 2, 64, True, 300),
    (2, 64, 4, 4, 128, True, None), (1, 129, 8, 2, 64, True, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FA_BWD_TC_CASES)
def test_flash_attention_backward_tensor_core_route(B, S, H, KV, hd, causal,
                                                    window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, tol = FA_BWD_TOL["bfloat16"]
    q, k, v = _qkv(B, S, S, H, KV, hd, torch.bfloat16, torch.bfloat16,
                   S * 7 + H + hd)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(S)
                     ).to("cuda", torch.bfloat16)
    kw = dict(causal=causal, window=window)
    before = dict(fa_bwd.route_launches)
    got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert fa_bwd.route_launches == {**before,
                                     "tensor_core": before["tensor_core"] + 1}
    lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
    for g, w in zip(got, want):
        _close_to_largest(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    ("bfloat16", 128, "tensor_core"), ("bfloat16", 64, "tensor_core"),
    ("bfloat16", 80, "cuda_core"), ("float32", 128, "cuda_core"),
    ("float32", 64, "tf32x3")])
def test_flash_attention_backward_routes_by_type_and_head_dim(dtype, hd,
                                                              route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, _ = FA_BWD_TOL[dtype]
    q, k, v = _qkv(2, 96, 96, 4, 2, hd, tdt, tdt, 5)
    before = dict(fa_bwd.route_launches)
    fa_bwd.flash_attention_bwd_cuda(q, k, v, torch.ones_like(q))
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fa_bwd.route_launches.items()} == {
        r: int(r == route) for r in fa_bwd.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (4, 1024, 32, 8, 128, True, None), (2, 300, 8, 2, 64, True, 100),
    (2, 130, 4, 4, 80, True, None)])
def test_flash_attention_backward_kernel_is_deterministic(B, S, H, KV, hd,
                                                          causal, window):
    """Two launches on the same inputs give the same bits on either route:
    the sums over a KV head's query heads stay inside one block and no
    kernel uses atomics, so a train step reproduces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = _qkv(B, S, S, H, KV, hd, torch.bfloat16, torch.bfloat16, 3)
    kw = dict(causal=causal, window=window)
    do = torch.randn_like(q)
    first = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    second = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# The 3xTF32 route of the backward (float32, hd 64): ragged sequences (not
# a multiple of the 32-, 64- and 128-row tiles), causal or not, windows
# (one of a single key), rep 1 to 8, fewer and more queries than keys,
# Whisper's cross-attention train shape.  B, Sq, Sk, H, KV, causal, window.
FA_BWD_TF32_CASES = [
    (1, 200, 200, 4, 4, True, None), (3, 77, 77, 8, 1, False, None),
    (1, 1000, 1000, 16, 2, True, 300), (1, 129, 129, 8, 2, True, 1),
    (2, 333, 200, 4, 4, True, None), (3, 77, 1000, 8, 2, False, None),
    (1, 1000, 77, 8, 1, False, None), (2, 300, 500, 4, 1, True, 100),
    (4, 448, 1500, 16, 16, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", FA_BWD_TF32_CASES)
def test_flash_attention_backward_tf32x3_route(B, Sq, Sk, H, KV, causal,
                                               window):
    """Against the plain gradient at FA_BWD_TOL's float32 limit, on the
    3xTF32 route, two launches equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = FA_BWD_TOL["float32"]
    q, k, v = _qkv(B, Sq, Sk, H, KV, 64, tdt, tdt, Sq * 5 + Sk + H)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(Sq)
                     ).to("cuda", tdt)
    kw = dict(causal=causal, window=window)
    before = dict(fa_bwd.route_launches)
    got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    again = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fa_bwd.route_launches.items()} == {
        r: 2 * int(r == "tf32x3") for r in fa_bwd.ROUTES}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
    for g, w in zip(got, want):
        _close_to_largest(g, w, tol)


# The backward where queries and keys differ in number (cross-attention;
# queries from position 0, so under a causal mask query i sees keys <= i):
# B, Sq, Sk, H, KV, hd, causal, window.  Whisper-medium's cross-attention
# at its train shape (448 decoder tokens on 1500 frames) and its encoder;
# fewer and more queries than keys, causal or not, rep 1, 4 and 8, a
# window, hd 64, 128 and 80; bf16 at hd 64 and 128 on the tensor cores,
# float32 at hd 64 on the 3xTF32 route, float32 at hd 128 and hd 80 on the
# CUDA cores.
FA_BWD_SQ_SK_CASES = [
    (4, 448, 1500, 16, 16, 64, False, None),
    (2, 1500, 1500, 16, 16, 64, False, None),
    (2, 200, 333, 8, 2, 128, True, None),
    (2, 333, 200, 4, 4, 64, True, None),
    (3, 77, 1000, 8, 2, 128, False, None),
    (1, 1000, 77, 8, 1, 64, False, None),
    (2, 300, 500, 4, 1, 64, True, 100),
    (1, 100, 300, 2, 2, 80, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", FA_BWD_SQ_SK_CASES)
@pytest.mark.parametrize("dtype", list(FA_BWD_TOL))
def test_flash_attention_backward_at_unequal_lengths(B, Sq, Sk, H, KV, hd,
                                                     causal, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = FA_BWD_TOL[dtype]
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, tdt, tdt, Sq * 3 + Sk)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(Sk)
                     ).to("cuda", tdt)
    kw = dict(causal=causal, window=window)
    route = fa_bwd.route(tdt, hd)
    before = dict(fa_bwd.route_launches)
    got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fa_bwd.route_launches.items()} == {
        r: int(r == route) for r in fa_bwd.ROUTES}
    assert (route == "tensor_core") == (tdt == torch.bfloat16 and hd != 80)
    assert (route == "tf32x3") == (tdt == torch.float32 and hd == 64)
    lse = fa_ref.flash_attention_lse_ref(q, k, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, do, lse, **kw)
    for g, w in zip(got, want):
        _close_to_largest(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FA_BWD_TOL))
def test_flash_attention_backward_at_unequal_lengths_is_deterministic(dtype):
    """Whisper's cross-attention train shape, twice: the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, _ = FA_BWD_TOL[dtype]
    q, k, v = _qkv(4, 448, 1500, 16, 16, 64, tdt, tdt, 9)
    do = torch.randn_like(q)
    first = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, causal=False)
    second = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, causal=False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (4, 448, 1500, 16, 16, 64, False), (2, 300, 300, 8, 2, 128, True),
    (1, 100, 300, 2, 2, 80, False)])
@pytest.mark.parametrize("dtype", list(FA_BWD_TOL))
def test_flash_attention_backward_holds_when_keys_are_alike(
        B, Sq, Sk, H, KV, hd, causal, dtype):
    """Keys 1 % apart (a deep encoder's frames, as Whisper's
    cross-attention reads them) spread each row's attention evenly, so dS
    = P (dP - D) is a difference of near-equal numbers: both routes
    against torch autograd through the plain forward in float32 on the
    same inputs.  D from the bf16 output, as FlashAttention-2 takes it,
    misses by ~0.4 of dq's largest entry here (tools/flash_bwd_accuracy.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt, tol = FA_BWD_TOL[dtype]
    g = torch.Generator().manual_seed(Sq + Sk)
    q = torch.randn(B, Sq, H, hd, generator=g).to("cuda", tdt)
    k = (torch.randn(1, 1, KV, hd, generator=g)
         + 0.01 * torch.randn(B, Sk, KV, hd, generator=g)).to("cuda", tdt)
    v = torch.randn(B, Sk, KV, hd, generator=g).to("cuda", tdt)
    do = torch.randn(B, Sq, H, hd, generator=g).to("cuda", tdt)
    got = fa_bwd.flash_attention_bwd_cuda(q, k, v, do, causal=causal)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = fa_ref.flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do.float())
    for gr, w in zip(got, want):
        _close_to_largest(gr.float(), w, tol)


# ssm_scan's backward: the forward's cases with and without h0, each with a
# gradient of the last state and without.  Tolerance 1e-4 of each
# gradient's largest entry (at least 1), as the forward's: exponentials
# (ex2.approx) and sums (over N, over the channels by atomics) in another
# order.
SSM_BWD_CASES = [
    (2, 128, 64, 16, False), (1, 64, 256, 8, True), (2, 96, 32, 16, False),
    (1, 200, 48, 4, True), (3, 77, 40, 8, True), (2, 100, 33, 16, True),
    (2, 3, 200, 16, False), (4, 1, 130, 16, True), (2, 256, 1024, 16, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,with_h0", SSM_BWD_CASES)
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_backward_kernel_matches_plain_version(B, S, D, N, with_h0,
                                                        with_dh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(B, S, D, N, with_h0, S * 7 + D, mamba_A=N == 16)
    g = torch.Generator().manual_seed(S + D)
    dy = torch.randn(B, S, D, generator=g).to("cuda")
    dh = torch.randn(B, D, N, generator=g).to("cuda") if with_dh else None
    before = ssm_bwd.launches
    got = ssm_bwd.ssm_scan_bwd_cuda(*args, dy, dh)
    torch.cuda.synchronize()
    assert ssm_bwd.launches == before + 1
    want = ssm_ref.ssm_scan_bwd_ref(*args, dy, dh)
    assert (got[5] is None) == (not with_h0)
    for gg, w in zip(got, want):
        if w is not None:
            _close_to_largest(gg, w, 1e-4)


@pytest.mark.cuda
def test_ssm_scan_gradient_goes_through_both_kernels(monkeypatch):
    """With inputs that require a gradient, ``ops.ssm_scan`` runs the
    forward kernel and its backward the backward kernel, never the plain
    gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(2, 70, 96, 16, True, 43, mamba_A=True)

    def refused(*a, **kw):
        raise AssertionError("the plain gradient ran on the card")

    monkeypatch.setattr(ssm_ref, "ssm_scan_bwd_ref", refused)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (ssm_kernel.launches, ssm_bwd.launches)
    y, h = ssm_ops.ssm_scan(*leaves)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ssm_kernel.launches, ssm_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    monkeypatch.undo()
    want = ssm_ref.ssm_scan_bwd_ref(*args, dy)
    for gg, w in zip(grads, want):
        _close_to_largest(gg, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,N,with_h0", [(4, 1024, 8192, 16, False),
                                             (2, 77, 300, 8, True)])
def test_ssm_scan_backward_kernel_is_deterministic(B, S, D, N, with_h0):
    """Two launches on the same inputs give the same bits: the sums over
    channel blocks and batch rows are taken in a fixed order, with no
    atomics, so a train step reproduces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ssm_inputs(B, S, D, N, with_h0, 31, mamba_A=True)
    g = torch.Generator().manual_seed(32)
    dy = torch.randn(B, S, D, generator=g).to("cuda")
    dh = torch.randn(B, D, N, generator=g).to("cuda") if with_h0 else None
    first = ssm_bwd.ssm_scan_bwd_cuda(*args, dy, dh)
    second = ssm_bwd.ssm_scan_bwd_cuda(*args, dy, dh)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------ continuous batching --
# the reduced archs the server takes (float32: the CUDA-core and scan
# kernels), with prompts of whole reduced chunks where a recurrence needs
# them (Jamba's Mamba takes S % min(32, S) == 0, xLSTM's too)
SERVER_CASES = [("granite-8b", {}, [5, 9, 7, 12]), ("olmo-1b", {}, [4, 5, 6]),
                ("jamba-v0.1-52b", {"moe": None}, [5, 32, 9, 12]),
                ("xlstm-1.3b", {}, [32, 64, 32])]


def _serve(name, changes, plens, n_new, device, max_len=80, dtype=None):
    """A reduced ``BatchedServer`` with 2 slots on ``device``, its weights
    drawn on the CPU from seed 0, prompts from seed 1.  Returns the
    requests (run to the end), the stats and the server."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import BatchedServer, Request
    cfg = dataclasses.replace(get_arch(name), **changes).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    model = build_model(cfg, max_seq=max_len)
    params = tree.map(lambda t: t.to(device), model.init(R.PRNGKey(0, "cpu")))
    toks = R.randint(R.PRNGKey(1, "cpu"), (len(plens), max(plens)), 0,
                     cfg.vocab_size)
    news = n_new if isinstance(n_new, list) else [n_new] * len(plens)
    server = BatchedServer(model, params, max_batch=2, max_len=max_len,
                           device=device)
    reqs = [Request(uid=i, prompt=toks[i, :p], max_new_tokens=n)
            for i, (p, n) in enumerate(zip(plens, news))]
    for r in reqs:
        server.submit(r)
    return reqs, server.run(), server


@pytest.mark.cuda
@pytest.mark.parametrize("name,changes,plens", SERVER_CASES,
                         ids=[c[0] + ("-no-experts" if c[1] else "")
                              for c in SERVER_CASES])
def test_server_on_the_card_gives_the_cpu_route_tokens(name, changes, plens):
    """The reduced server (float32) on the card and on the port's CPU route
    (which tests/test_torch_scheduler.py holds to the reference's server):
    the same tokens and stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    card, card_stats, _ = _serve(name, changes, plens, 6, "cuda")
    cpu, cpu_stats, _ = _serve(name, changes, plens, 6, "cpu")
    assert card_stats == cpu_stats
    assert [r.output for r in card] == [r.output for r in cpu]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_server_slot_past_the_cache_end_on_the_card(dtype):
    """A slot freed at position 23 of a 24-position cache advances to 33
    while the other decodes: its writes land on the cache's last position
    (no device-side assert), every request completes, and with bf16 the
    batched steps run split-K with a (B,) kv_len past the cache, the
    prefills on the tensor cores.  float32: the CPU route's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tdt = getattr(torch, dtype)
    fa_kernel.route_launches.update(dict.fromkeys(fa_kernel.route_launches, 0))
    card, stats, server = _serve("olmo-1b", {}, [20, 3], [4, 14], "cuda",
                                 max_len=24, dtype=tdt)
    torch.cuda.synchronize()
    assert stats == {"steps": 13, "prefills": 2, "completed": 2}
    assert int(server.pos[0]) == 33 and [len(r.output) for r in card] == [4, 14]
    if dtype == "bfloat16":
        # 2 layers: 2 prefills (20 tokens on the tensor cores, 3 split-K)
        # and 13 decode steps
        assert fa_kernel.route_launches == {"tensor_core": 2,
                                            "split_k": 2 + 2 * 13,
                                            "tf32x3": 0, "cuda_core": 0}
    else:
        cpu, cpu_stats, _ = _serve("olmo-1b", {}, [20, 3], [4, 14], "cpu",
                                   max_len=24, dtype=tdt)
        assert cpu_stats == stats
        assert [r.output for r in card] == [r.output for r in cpu]


# ------------------------------------------------------ mesh schedules --
MESH_HP = dict(local_epochs=2, mh_pop=4, mh_generations=2, lr=0.1)


def _mesh_toy_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lp = torch.log_softmax(logits, -1)
    nll = -torch.take_along_dim(lp, batch["y"][:, None], -1).mean()
    return nll, (logits.argmax(-1) == batch["y"]).float().mean()


def _mesh_toy_task():
    from repro_torch.core.client import Task

    def init_params(key):
        return {"w": R.normal(R.split(key)[0], (6, 3)) * 0.1,
                "b": torch.zeros((3,), device=key.device)}
    return Task(init_params, _mesh_toy_loss)


def _mesh_rank(rank, params, shards, keys):
    """One FedBWO round on a 2-rank host mesh on cuda:0 with the kernel:
    this rank's launches, the scores and the new model."""
    from repro_torch.core.client import ClientHP
    from repro_torch.core.distributed import make_fedx_round
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.metaheuristics import bwo
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(2, device_type="cuda")
    rnd = make_fedx_round(_mesh_toy_task(), ClientHP(**MESH_HP),
                          bwo(use_kernel=True), mesh)
    kernel_mod.launches = 0
    new, scores = rnd(tree.map(lambda a: a.to(dev), params),
                      tree.map(lambda a: a[None].to(dev), shards[rank]),
                      keys[rank:rank + 1].to(dev))
    return {"launches": kernel_mod.launches, "scores": scores.cpu(),
            "params": tree.map(lambda a: a.cpu(), new),
            "traffic": dict(rnd.traffic)}


@pytest.mark.cuda
def test_mesh_round_on_two_ranks_matches_the_sequential_engine():
    """Two gloo ranks on one card (``run_ranks``), the toy task of the
    reference's distributed test with ``bwo(use_kernel=True)``, against the
    sequential engine in this process from the same start and keys: the
    same winner, scores within 1e-5 relative, the new model the winner's,
    one kernel launch a generation in each rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core.client import ClientHP
    from repro_torch.core.server import Server, get_strategy
    from repro_torch.launch.mesh import run_ranks
    kernel_mod.build()                  # once, before the ranks
    key = R.PRNGKey(0, "cuda")
    x = R.normal(key, (2, 4, 16, 6))
    y = (x @ R.normal(R.PRNGKey(9, "cuda"), (6, 3))).argmax(-1)
    shards = [{"x": x[k], "y": y[k]} for k in range(2)]
    server = Server(_mesh_toy_task(), get_strategy("fedbwo", use_kernel=True),
                    ClientHP(**MESH_HP), shards, key, engine="sequential")
    start = server.global_params
    keys = R.split(server.rng, 4)[2:]          # Server.run_round's schedule
    outs = run_ranks(2, _mesh_rank, tree.map(lambda a: a.cpu(), start),
                     [tree.map(lambda a: a.cpu(), s) for s in shards],
                     keys.cpu(), timeout=300)
    info = server.run_round()
    want = torch.tensor(info["scores"])
    for out in outs:
        assert out["launches"] == MESH_HP["mh_generations"]
        assert int(torch.argmin(out["scores"])) == info["best_client"]
        torch.testing.assert_close(out["scores"], want, rtol=1e-5, atol=0)
        for g, w in zip(tree.leaves(out["params"]),
                        tree.leaves(server.global_params)):
            torch.testing.assert_close(g, w.cpu(), rtol=1e-5, atol=1e-6)
        assert out["traffic"] == {"all_gather": 8, "broadcast": 4 * 21}


# ------------------------------------------------------------ threefry --
# kind and its parameters: the kernel's draws as random.py's samplers ask
TF_KINDS = {"pairs": {}, "bits": {}, "uniform": {"lo": 0.0, "hi": 1.0},
            "uniform(-1, 1)": {"lo": -1.0, "hi": 1.0},
            "bernoulli": {"p": 0.4}}


def _tf_draw(keys, start, n, kind, **kw):
    """The kernel, one launch for all keys, and the int64 route."""
    kind = kind.split("(")[0]
    before = tf_kernel.launches
    got = tf_ops.threefry(keys, start, n, kind, kw.get("lo", 0.0),
                          kw.get("hi", 1.0), kw.get("p", 0.0))
    torch.cuda.synchronize()
    assert tf_kernel.launches == before + 1
    return got, tf_ref.threefry_ref(keys, start, n, kind, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TF_KINDS))
def test_threefry_kernel_is_the_int64_route_at_the_cells_shapes(kind):
    """Under vmap over 10 clients' keys, the draw at the BWO bit planes'
    shape (6, 2,465,408) is one launch, equal bit for bit to the int64
    route key by key; so is split's pair of words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    keys = R.split(R.PRNGKey(31, "cuda"), 10)
    n = 6 * 2_465_408 if kind != "pairs" else 5
    k = kind.split("(")[0]
    kw = TF_KINDS[kind]
    before = tf_kernel.launches
    got = torch.func.vmap(lambda key: tf_ops.draw(key, 0, n, k, **kw))(keys)
    torch.cuda.synchronize()
    assert tf_kernel.launches == before + 1
    want = tf_ref.threefry_ref(keys, 0, n, k, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", [(0, 2**26 + 5), (3 * 2**32 + 17, 4099),
                                     (2**32 - 7, 33)])
@pytest.mark.parametrize("kind", list(TF_KINDS))
def test_threefry_kernel_across_long_and_high_counter_ranges(kind, start, n):
    """A draw across 2^26 counters (the CPU route's piece), and starts at
    and past 2^32, where the counter's high word is not 0, at lengths that
    are no multiple of 4 under 3 keys (rows start off the 16-byte
    alignment): bit for bit the int64 route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    keys = R.split(R.PRNGKey(start % 1000 + n, "cuda"), 3 if n < 2**20 else 1)
    got, want = _tf_draw(keys, start, n, kind, **TF_KINDS[kind])
    assert torch.equal(got, want), f"{int((got != want).sum())} differ"


@pytest.mark.cuda
def test_threefry_samplers_take_the_kernel_on_the_card():
    """random.py's samplers on a CUDA key: one launch each, the same words
    as the int64 route (bits widened, bits32, uniform, bernoulli, split,
    randint), and every draw inside a threefry span counted by
    ``threefry.words``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    key = R.PRNGKey(5, "cuda")
    shape = (7, 333)
    before = tf_kernel.words
    assert torch.equal(R.bits(key, shape), tf_ref.draw_ref(
        key, 0, 7 * 333, "bits").reshape(shape).to(torch.int64) & R.MASK)
    assert torch.equal(R.bits32(key, shape),
                       tf_ref.draw_ref(key, 0, 7 * 333, "bits").reshape(shape))
    assert torch.equal(R.uniform(key, shape), tf_ref.draw_ref(
        key, 0, 7 * 333, "uniform").reshape(shape))
    assert torch.equal(R.bernoulli(key, 0.3, shape), tf_ref.draw_ref(
        key, 0, 7 * 333, "bernoulli", p=0.3).reshape(shape))
    assert torch.equal(R.split(key, 4), tf_ref.draw_ref(key, 0, 4, "pairs"))
    assert tf_kernel.words == before + 4 * 7 * 333 + 4
    # a span that is no power of two: the float64 map over the kernel's bits
    lo = torch.full((), -2.0, device="cuda")
    hi = torch.full((), 3.0, device="cuda")
    assert torch.equal(R.uniform(key, (50,), minval=-2.0, maxval=3.0),
                       R._uniform_at(key, 0, 50, lo, hi, False))
    got = R.randint(key, (6, 5), 0, 1000).cpu()
    assert torch.equal(got, R.randint(R.PRNGKey(5, "cpu"), (6, 5), 0, 1000))


@pytest.mark.cuda
def test_threefry_normal_within_an_ulp_of_the_plain_route():
    """The kernel's normal (erfinv in registers, no contraction) against
    the torch ops' route on the card at the BWO seeding's shape under 10
    keys: the count of elements that differ, within 1 ulp and 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    keys = R.split(R.PRNGKey(77, "cuda"), 10)
    n = 6 * 2_465_322
    got = torch.func.vmap(lambda k: R.normal(k, (n,)))(keys)
    want = tf_ref.threefry_ref(keys, 0, n, "normal", lo=R._NORMAL_LO, hi=1.0)
    differ = got != want
    ulp = (torch.nextafter(want.abs(), torch.full_like(want, float("inf")))
           - want.abs())
    print(f"normal: {int(differ.sum())} of {got.numel()} differ from the "
          f"plain route; largest {float((got - want).abs().max()):.3g}")
    assert ((got - want).abs() <= ulp).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_threefry_graph_replays_under_the_key_in_memory():
    """A captured draw reads its key from device memory at replay: write
    another key into the captured buffer, replay, and get that key's draw
    (the round keys of a captured block are computed on the device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    key = R.PRNGKey(1, "cuda")
    n = 4 * 130_001
    for kind, draw in (("bits", lambda k: R.bits32(k, (n,))),
                       ("pairs", lambda k: R.split(k, 3)),
                       ("normal", lambda k: R.normal(k, (n,)))):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            draw(key)                                    # warm-up
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = draw(key)
        for seed in (2, 3):
            new = R.PRNGKey(seed, "cuda")
            key.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, draw(new)), (kind, seed)
