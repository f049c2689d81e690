"""The port's attention against the reference's, on the CPU: the public
``ops.flash_attention`` (here its plain version, ``ref.py``) against the
JAX Pallas kernel run in interpret mode and against its oracle, and the
port's ``blockwise_attention`` against the JAX one.  Inputs are drawn with
numpy from a seed and handed to both packages.  Also the kernels' routing
(``flash_attention.route``) and the split-K decode's arithmetic in plain
torch (its chunks, partials and merge, ``ref.py``) against the oracles.

Tolerances: float32 2e-5 (fp32 math in both, sums in another order);
bfloat16 3e-2 (both round an fp32 result to bf16, whose step near 1 is
2^-8, and the inputs' products are summed in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jref  # noqa: E402
from repro.models.attention import blockwise_attention as jblockwise  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)

# B, Sq, Sk, H, KV, hd, causal, window: the reference's kernel sweep
# (tests/test_kernels.py)
CASES = [
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 512, 512, 4, 4, 128, True, 128),
    (2, 128, 128, 8, 1, 32, False, None),
    (1, 300, 300, 2, 2, 80, True, None),     # non-multiple seq + odd hd
    (1, 256, 256, 4, 4, 128, True, 64),
]


def _qkv(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", CASES)
def test_matches_the_pallas_kernel_and_its_oracle(B, Sq, Sk, H, KV, hd,
                                                  causal, window):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, Sq + hd)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
    kernel = jflash(*_j(q, k, v), causal=causal, window=window, bq=128,
                    bk=128, interpret=True)
    oracle = jref(*_j(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_bf16_matches_the_pallas_kernel():
    q, k, v = _qkv(1, 256, 256, 4, 2, 128, 0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want = jflash(jq, jk, jv, causal=True, bq=128, bk=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_decode_with_a_valid_length():
    """One query against a cache of 40 positions of which 23 are valid
    (the reference's ``seq_k``), and per-row lengths (the reference's
    blockwise attention with a (B,) ``kv_len``)."""
    q, k, v = _qkv(3, 1, 40, 4, 2, 64, 5)
    got = ops.flash_attention(*_t(q, k, v), causal=False, kv_len=23)
    want = jref(*_j(q, k, v), causal=False, seq_k=23)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    lens = np.array([23, 40, 1], np.int32)
    got = ops.flash_attention(*_t(q, k, v), causal=False,
                              kv_len=torch.as_tensor(lens))
    want = jblockwise(*_j(q, k, v), causal=False, window=None,
                      kv_len=jnp.asarray(lens), q_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_windowed_decode_reads_the_last_window():
    """The reference's sliding-window decode: the last ``win`` cache
    positions, with kv_len = min(kv_len, win).  It equals causal attention
    with the window over the whole cache at the query's position."""
    q, k, v = _qkv(2, 1, 48, 4, 4, 64, 9)
    pos, win = 37, 16                       # kv_len = pos + 1 = 38
    start = pos + 1 - win
    tq, tk, tv = _t(q, k, v)
    got = ops.flash_attention(tq, tk[:, start:start + win],
                              tv[:, start:start + win], causal=False,
                              kv_len=win)
    want = jblockwise(*_j(q, k[:, start:start + win], v[:, start:start + win]),
                      causal=False, window=None, kv_len=win, q_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    full = ops.flash_attention(tq, tk, tv, causal=True, window=win,
                               q_offset=pos)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32)


@pytest.mark.parametrize("q_block", [8, 1024])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_blockwise_attention_matches_the_reference(q_block, causal, window):
    q, k, v = _qkv(2, 24, 64, 4, 2, 32, 3)
    kw = dict(causal=causal, window=window, q_offset=40, kv_len=60,
              q_block=q_block)
    got = blockwise_attention(*_t(q, k, v), **kw)
    want = jblockwise(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # and the kernel's public entry computes the same function
    fa = ops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_offset=40, kv_len=60)
    np.testing.assert_allclose(got.numpy(), fa.numpy(), **F32)


def test_other_devices_raise():
    q = torch.zeros(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)


# ------------------------------------------------------------- routing --
BF, F32T = torch.bfloat16, torch.float32


@pytest.mark.parametrize("qdt,kvdt,hd,Sq,tma_ok,want", [
    (BF, BF, 128, 1024, True, "tensor_core"),
    (BF, BF, 64, 17, True, "tensor_core"),
    (BF, BF, 128, 17, False, "cuda_core"),      # strides TMA cannot read
    (BF, BF, 128, 16, True, "split_k"),
    (BF, BF, 64, 1, False, "split_k"),           # split-K reads any stride
    (BF, BF, 32, 1024, True, "cuda_core"),
    (BF, BF, 80, 1, True, "cuda_core"),
    (F32T, F32T, 64, 1500, True, "tf32x3"),      # Whisper's float32 encoder
    (F32T, F32T, 64, 32, True, "tf32x3"),        # and its cross prefill
    (F32T, F32T, 64, 17, False, "cuda_core"),    # strides TMA cannot read
    (F32T, F32T, 128, 1024, True, "cuda_core"),
    (F32T, F32T, 32, 1024, True, "cuda_core"),
    (F32T, F32T, 64, 16, True, "cuda_core"),     # float32 decode
    (F32T, F32T, 64, 1, True, "cuda_core"),
    (F32T, BF, 128, 1, True, "cuda_core"),       # float32 q on a bf16 cache
    (F32T, BF, 64, 1500, True, "cuda_core"),
])
def test_route_by_types_head_dim_and_queries(qdt, kvdt, hd, Sq, tma_ok, want):
    from repro_torch.kernels.flash_attention import flash_attention as fk
    assert fk.route(qdt, kvdt, hd, Sq, tma_ok=tma_ok) == want


@pytest.mark.parametrize("qdt,kvdt,hd,err", [
    (BF, BF, 96, ValueError), (F32T, F32T, 256, ValueError),
    (BF, F32T, 128, TypeError), (torch.float16, torch.float16, 64, TypeError),
    (F32T, torch.float64, 64, TypeError),
])
def test_route_raises_on_what_no_kernel_takes(qdt, kvdt, hd, err):
    from repro_torch.kernels.flash_attention import flash_attention as fk
    with pytest.raises(err):
        fk.route(qdt, kvdt, hd, 1)


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (BF, 128, True, "tensor_core"), (BF, 64, True, "tensor_core"),
    (BF, 128, False, "cuda_core"),              # a base TMA cannot read
    (BF, 32, True, "cuda_core"), (BF, 80, True, "cuda_core"),
    (F32T, 64, True, "tf32x3"),                 # Whisper's float32 encoder
    (F32T, 64, False, "cuda_core"),
    (F32T, 128, True, "cuda_core"), (F32T, 80, True, "cuda_core"),
    (F32T, 32, False, "cuda_core"),
])
def test_backward_route_by_type_head_dim_and_alignment(dtype, hd, aligned,
                                                       want):
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
    assert fb.route(dtype, hd, aligned=aligned) == want


@pytest.mark.parametrize("dtype,hd,err", [
    (BF, 96, ValueError), (F32T, 256, ValueError),
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
])
def test_backward_route_raises_on_what_no_kernel_takes(dtype, hd, err):
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
    with pytest.raises(err):
        fb.route(dtype, hd)


def test_backward_wrapper_takes_cuda_tensors_only():
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_attention_bwd_cuda(q, q, q, q)
    assert fb.launches == 0 and fb.route_launches == {
        "tensor_core": 0, "tf32x3": 0, "cuda_core": 0}


H100_SMS = 132


@pytest.mark.parametrize("Sk,groups,chunk", [
    (1056, 64, 192),      # OLMo-1B decode: B 4 x 16 KV heads -> 6 chunks
    (1056, 32, 192),      # Jamba decode: B 4 x 8 KV heads -> 6 chunks
    (40, 6, 192), (100_000, 1, 256), (1056, 512, 1408),
])
def test_split_k_chunk_fills_the_grid_from_shapes_alone(Sk, groups, chunk):
    from repro_torch.kernels.flash_attention.flash_attention import (
        SPLIT_K_BLOCKS_PER_SM, split_k_chunk)
    got = split_k_chunk(Sk, groups, H100_SMS)
    assert got == chunk and got % 64 == 0
    assert groups * -(-Sk // got) <= H100_SMS * SPLIT_K_BLOCKS_PER_SM + groups


# ------------------------------------------- split-K, in plain torch --
# B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len, chunk: decode with
# per-row lengths shorter than one chunk and equal to Sk, 1 to 16 queries,
# GQA up to rep 8, windows, chunks of one tile and of several
SPLIT_CASES = [
    (3, 1, 40, 4, 2, 64, False, None, 0, [23, 40, 1], None),
    (3, 1, 300, 4, 2, 64, False, None, 0, [23, 300, 130], 64),
    (2, 1, 100, 4, 4, 128, True, 16, 70, None, 64),
    (2, 5, 300, 8, 2, 64, True, None, 290, [300, 40], 128),
    (2, 16, 200, 16, 2, 32, True, 50, 150, None, 64),
    (1, 7, 500, 8, 1, 64, True, 128, 400, 450, 192),
    (4, 1, 1056, 4, 4, 32, False, None, 0, 1040, None),
]


def _lens(kv_len):
    return (torch.as_tensor(np.array(kv_len, np.int32))
            if isinstance(kv_len, list) else kv_len)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,q_offset,kv_len,chunk",
                         SPLIT_CASES)
def test_split_k_partials_and_merge_match_the_oracle(
        B, Sq, Sk, H, KV, hd, causal, window, q_offset, kv_len, chunk):
    """The split-K route's arithmetic in plain torch (same chunks, empty
    partials, -1e30 rows) against the port's flash_attention_ref and the
    JAX oracle, within 1e-6 in fp32: only the order of the sums differs."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        split_k_chunk)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, flash_attention_split_k_ref)
    if chunk is None:                   # the wrapper's chunk on an H100
        chunk = split_k_chunk(Sk, B * KV, H100_SMS)
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, Sk + Sq)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=_lens(kv_len))
    got = flash_attention_split_k_ref(*_t(q, k, v), chunk=chunk, **kw)
    want = flash_attention_ref(*_t(q, k, v), **kw)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    if not isinstance(kv_len, list):   # the JAX oracle takes one length
        joracle = jref(*_j(q, k, v), causal=causal, window=window,
                       q_offset=q_offset, seq_k=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(joracle), **tol)


def test_split_k_empty_partials_are_skipped():
    """Chunks past a row's kv_len (and before the window) come out empty,
    m = -1e30 and l = 0; a row that sees no key in a whole non-empty chunk
    has m = -1e30 there and weighs nothing in the merge, with no NaN."""
    from repro_torch.kernels.flash_attention.ref import (
        NEG_INF, flash_attention_ref, split_k_merge, split_k_partials)
    q, k, v = _qkv(2, 4, 256, 2, 1, 64, 4)
    kw = dict(causal=True, window=8, q_offset=100,
              kv_len=torch.tensor([256, 90]))
    m, l, acc = split_k_partials(*_t(q, k, v), chunk=64, **kw)
    # row 0 sees keys 93..103: chunk 1 only; row 1 is cut at 90: none past
    assert (l[0, [0, 2, 3]] == 0).all() and (m[0, [0, 2, 3]] == NEG_INF).all()
    assert (l[0, 1] > 0).all() and (l[1] == 0).all()
    out = split_k_merge(m, l, acc)
    assert torch.isfinite(out).all()
    want = flash_attention_ref(*_t(q, k, v), **kw)
    np.testing.assert_allclose(out.permute(0, 2, 1, 3)[0].numpy(),
                               want[0].numpy(), rtol=1e-6, atol=1e-6)
