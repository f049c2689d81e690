"""The threefry operator (``repro_torch::threefry``) on CPU keys, where it
takes its plain version (``random.py``'s int64 route): its vmap rule folds
batches of keys, nested vmaps included, into one call; its schema and fake
kernel pass ``opcheck``; the samplers' CPU and meta routes are unchanged;
the BWO bit planes are the int32 words of ``bits``.  The kernel itself is
held to the plain version on the card (``test_torch_kernels_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as R  # noqa: E402
from repro_torch.kernels.bwo_evolve import ops as bwo_ops  # noqa: E402
from repro_torch.kernels.threefry import ops, ref  # noqa: E402
from repro_torch.kernels.threefry import threefry as kernel_mod  # noqa: E402


def as_i32_words(bits):
    """The int64 round trip the BWO planes took before ``bits32``: unsigned
    32-bit values held in int64 -> the int32 words of the same bits."""
    return (bits - ((bits >> 31) << 32)).to(torch.int32)


# each sampler as the operator draws it, beside random.py's CPU route
SAMPLERS = {
    "split": (lambda k, n: ops.draw(k, 0, n, "pairs"),
              lambda k, n: R.split(k, n)),
    "bits32": (lambda k, n: ops.draw(k, 0, n, "bits"),
               lambda k, n: R.bits32(k, (n,))),
    "uniform": (lambda k, n: ops.draw(k, 0, n, "uniform", lo=-1.0, hi=1.0),
                lambda k, n: R.uniform(k, (n,), minval=-1.0, maxval=1.0)),
    "bernoulli": (lambda k, n: ops.draw(k, 0, n, "bernoulli", p=0.3),
                  lambda k, n: R.bernoulli(k, 0.3, (n,))),
    "normal": (lambda k, n: ops.draw(k, 0, n, "normal", lo=R._NORMAL_LO,
                                     hi=1.0),
               lambda k, n: R.normal(k, (n,))),
}


@pytest.mark.parametrize("n", [1, 7, 130])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_vmapped_draws_are_one_call_equal_to_the_per_key_loop(
        monkeypatch, sampler, n):
    """Under vmap over 4 keys, and under a vmap of vmaps over 3 x 2 keys,
    the operator runs once over all the keys (its vmap rule folds the
    batch dimensions into K) and equals the per-key loop bit for bit, which
    equals random.py's own draw."""
    op, plain = SAMPLERS[sampler]
    calls = []
    inner = ref.threefry_ref
    monkeypatch.setattr(ref, "threefry_ref", lambda keys, *a, **kw: (
        calls.append(keys.shape[0]), inner(keys, *a, **kw))[1])
    keys = R.split(R.PRNGKey(n, "cpu"), 6)
    loop = torch.stack([op(k, n) for k in keys])
    assert calls == [1] * 6
    assert torch.equal(loop, torch.stack([plain(k, n) for k in keys]))
    calls.clear()
    assert torch.equal(torch.func.vmap(lambda k: op(k, n))(keys), loop)
    nested = torch.func.vmap(torch.func.vmap(lambda k: op(k, n)))(
        keys.reshape(3, 2, 2))
    assert torch.equal(nested, loop.reshape(3, 2, *loop.shape[1:]))
    assert calls == [6, 6]


def test_a_vmapped_draw_inside_a_gradient_is_the_plain_draw():
    """Dropout draws its mask inside ``torch.func.grad`` of the loss under
    vmap over clients: the operator passes both transforms."""
    keys = R.split(R.PRNGKey(2, "cpu"), 3)
    x = torch.ones(3, 40)

    def loss(w, k):
        keep = ops.draw(k, 0, 40, "bernoulli", p=0.8)
        return torch.where(keep, w * 2.0, 0.0).sum()

    got = torch.func.vmap(torch.func.grad(loss))(x, keys)
    want = torch.stack([R.bernoulli(k, 0.8, (40,)) for k in keys]) * 2.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", list(kernel_mod.KINDS))
def test_the_operator_passes_opcheck(kind):
    """Schema, fake (shape-only) kernel and CPU implementation, at a start
    whose counters cross 2^32 and at a length that is no multiple of 4."""
    keys = R.split(R.PRNGKey(9, "cpu"), 3)
    torch.library.opcheck(ops.threefry, (keys, 2**32 - 3, 9, kind,
                                         R._NORMAL_LO if kind == "normal"
                                         else 0.0, 1.0, 0.4))


def test_cpu_keys_take_the_plain_version_and_launch_nothing():
    before = (kernel_mod.launches, kernel_mod.words)
    key = R.PRNGKey(4, "cpu")
    for draw in (lambda: R.split(key, 3), lambda: R.bits32(key, (5,)),
                 lambda: R.uniform(key, (5,)), lambda: R.normal(key, (5,)),
                 lambda: R.bernoulli(key, 0.5, (5,)),
                 lambda: ops.draw(key, 0, 5, "bits")):
        draw()
    assert (kernel_mod.launches, kernel_mod.words) == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.threefry_cuda(R.split(key, 2), 0, 5, "bits")
    with pytest.raises(ValueError, match="shape"):
        ops.draw(torch.zeros(3, dtype=torch.int64), 0, 5, "bits")


def test_a_meta_key_gives_shapes_alone():
    key = torch.empty(2, dtype=torch.int64, device="meta")
    for draw, dtype in ((R.bits32, torch.int32), (R.bits, torch.int64),
                        (R.uniform, torch.float32),
                        (R.normal, torch.float32)):
        out = draw(key, (3, 5))
        assert out.device.type == "meta" and out.dtype == dtype
        assert tuple(out.shape) == (3, 5)
    mask = R.bernoulli(key, 0.5, (4,))
    assert mask.device.type == "meta" and mask.dtype == torch.bool


@pytest.mark.parametrize("P,D", [(3, 100), (6, 300), (2, 129)])
def test_bwo_planes_are_the_int32_words_of_bits(P, D):
    """``ops.sample``'s two bit planes, drawn by ``bits32``, equal the int64
    ``bits`` draw's words, word for word, at the 128-padded shape."""
    key = R.PRNGKey(P * 1000 + D, "cpu")
    Dp = -(-D // 128) * 128
    _, _, r_b1, r_b2, _ = R.split(key, 5)
    _, _, _, b1, b2, _ = bwo_ops.sample(torch.zeros(P, D), torch.zeros(P),
                                        key, pm=0.4, procreate_frac=0.6)
    for got, k in ((b1, r_b1), (b2, r_b2)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (P, Dp)
        assert torch.equal(got, as_i32_words(R.bits(k, (P, Dp))))
