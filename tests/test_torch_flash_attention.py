"""The port's attention against the reference's, on the CPU: the public
``ops.flash_attention`` (here its plain version, ``ref.py``) against the
JAX Pallas kernel run in interpret mode and against its oracle, and the
port's ``blockwise_attention`` against the JAX one.  Inputs are drawn with
numpy from a seed and handed to both packages.

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
