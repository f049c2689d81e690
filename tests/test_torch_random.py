"""The port's threefry draws against ``jax.random``: exact for every
sampler but ``normal``, which goes through erfinv (within 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import random as R  # noqa: E402

SEEDS = [0, 1, 42, 7, 2**31 - 1]
SHAPES = [(), (1,), (7,), (3, 128), (6, 4097), (2, 3, 5), (4, 1, 33)]


def tkey(jkey):
    return R.as_key(np.asarray(jkey), "cpu")


def np64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed, "cpu")
    assert (np64(jk) == tk.numpy()).all()
    for num in (2, 3, 7, 12):
        assert (np64(jax.random.split(jk, num)) == R.split(tk, num).numpy()).all()
    # a split key splits again the same way (the round schedule's chain)
    jk2 = jax.random.split(jk, 4)[3]
    assert (np64(jax.random.split(jk2)) ==
            R.split(R.split(tk, 4)[3]).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, "cpu")
    assert (np64(jax.random.bits(jk, shape, jnp.uint32))
            == R.bits(tk, shape).numpy()).all()
    got = R.uniform(tk, shape).numpy()
    assert got.dtype == np.float32
    assert (np.asarray(jax.random.uniform(jk, shape)) == got).all()
    lo_hi = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    assert (lo_hi == R.uniform(tk, shape, minval=-2.0, maxval=3.0).numpy()).all()
    for p in (0.1, 0.4, 0.8):
        assert (np.asarray(jax.random.bernoulli(jk, p, shape))
                == R.bernoulli(tk, p, shape).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("bounds", [(0, 10), (0, 3), (-5, 1000), (3, 3),
                                    (0, 70000), (0, 2**31 - 1)])
def test_randint(seed, bounds):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, "cpu")
    for shape in [(), (6,), (3, 5)]:
        want = np.asarray(jax.random.randint(jk, shape, *bounds))
        got = R.randint(tk, shape, *bounds).numpy()
        assert got.dtype == want.dtype == np.int32
        assert (want == got).all()


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(7,), (3, 128), (6, 4097), (50, 32, 3)])
def test_normal_within_erfinv_rounding(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = R.normal(R.PRNGKey(seed, "cpu"), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 10, 90, 1000, 70000])
def test_permutation(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = R.permutation(R.PRNGKey(seed, "cpu"), n).numpy()
    assert (want == got).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,m", [(10, 3), (10, 10), (5, 1), (30, 7), (3, 2)])
def test_choice(seed, n, m):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, "cpu")
    assert (np.asarray(jax.random.choice(jk, n, (m,), replace=False))
            == R.choice(tk, n, (m,)).numpy()).all()


def test_key_from_jax_array_is_the_same_key():
    jk = jax.random.split(jax.random.PRNGKey(3), 5)[2]
    assert (np64(jax.random.bits(jk, (9,)))
            == R.bits(tkey(jk), (9,)).numpy()).all()
    with pytest.raises(ValueError):
        R.bits(torch.zeros(3, dtype=torch.int64), (2,))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(7,), (3, 128), (4, 512)])
def test_gumbel_within_log_rounding(seed, shape):
    """``-log(-log(u))``: the uniforms are exact, ``log`` may differ in the
    last bit."""
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = R.gumbel(R.PRNGKey(seed, "cpu"), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B,V,scale", [(1, 2, 1.0), (4, 512, 1.0),
                                       (4, 512, 5.0), (3, 50304, 2.0),
                                       (8, 33, 0.1)])
def test_categorical_gives_the_reference_tokens(seed, B, V, scale):
    logits = (np.random.default_rng(seed % 1000 + V).normal(size=(B, V))
              * scale).astype(np.float32)
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, "cpu")
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = R.categorical(tk, torch.as_tensor(logits)).numpy()
    assert got.shape == want.shape == (B,)
    assert (got == want).all()


# ------------------------------------------------- draws made in pieces --
@pytest.mark.parametrize("piece", [5, 1000, 2048])
@pytest.mark.parametrize("sampler", ["bits", "uniform", "normal"])
def test_a_draw_in_pieces_is_the_whole_draw(monkeypatch, sampler, piece):
    """Above ``PIECE`` elements a draw is filled piece by piece over
    disjoint counter ranges: the same values, bit for bit, and the
    reference's (bits and uniform exactly, normal within erfinv's bit)."""
    shape = (7, 333)
    tk, jk = R.PRNGKey(11, "cpu"), jax.random.PRNGKey(11)
    draw = getattr(R, sampler)
    whole = draw(tk, shape)
    monkeypatch.setattr(R, "PIECE", piece)
    got = draw(tk, shape)
    assert got.dtype == whole.dtype and got.shape == whole.shape
    assert torch.equal(got, whole)
    if sampler == "bits":
        assert (np64(jax.random.bits(jk, shape, jnp.uint32)) == got.numpy()).all()
    elif sampler == "uniform":
        assert (np.asarray(jax.random.uniform(jk, shape)) == got.numpy()).all()
    else:
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax.random.normal(jk, shape)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("start", [0, 2**32 - 5, 2**32, 3 * 2**32 + 17])
def test_a_piece_hashes_its_own_counters(start):
    """A piece starting at ``start`` hashes the 64-bit counters
    start..start+n-1 as JAX's partitionable layout does: high word, low
    word, bits the XOR of the two outputs.  Held to JAX's threefry2x32
    directly, across and above 2^32 (a 4.46 G-element stack of experts
    reaches them)."""
    from jax._src import prng
    n = 9
    jk = jax.random.PRNGKey(12)
    idx = np.arange(start, start + n, dtype=np.uint64)
    out = np.asarray(prng.threefry_2x32(jk, jnp.asarray(np.concatenate(
        [(idx >> 32).astype(np.uint32), (idx & R.MASK).astype(np.uint32)]))))
    want = (out[:n] ^ out[n:]).astype(np.int64)
    assert (R._bits_at(tkey(jk), start, n).numpy() == want).all()
    # normal_at maps those bits as normal() maps a whole draw's
    if start == 0:
        np.testing.assert_array_equal(R.normal_at(tkey(jk), 0, n).numpy(),
                                      R.normal(tkey(jk), (n,)).numpy())


def test_only_float32_uniform_and_normal_draws():
    for draw in (R.uniform, R.normal):
        with pytest.raises(NotImplementedError, match="float32"):
            draw(R.PRNGKey(0, "cpu"), (3,), torch.bfloat16)


NORMAL_DRAWS = """
import sys
import numpy as np
import torch
from repro_torch import random as R
out = {"threads": np.int64(torch.get_num_threads())}
for seed in (0, 1, 42):
    out[f"s{seed}"] = R.normal(R.PRNGKey(seed, "cpu"), (512, 256)).numpy()
np.savez(sys.argv[1], **out)
"""


def test_normal_at_torch_default_thread_count(tmp_path):
    """The draws of a fresh process that keeps torch's own thread count
    (this file pins 2 threads), against JAX's, within erfinv's rounding."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    path = tmp_path / "draws.npz"
    subprocess.run([sys.executable, "-c", NORMAL_DRAWS, str(path)], env=env,
                   check=True, timeout=120)
    got = np.load(path)
    assert int(got["threads"]) >= 1
    for seed in (0, 1, 42):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (512, 256)))
        np.testing.assert_allclose(got[f"s{seed}"], want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{int(got['threads'])} threads")


INTERVALS = {"(0, 1)": (0.0, 1.0), "(nextafter(-1, 0), 1)": (R._NORMAL_LO, 1.0),
             "(-1, 1)": (-1.0, 1.0),
             "(tiny, 1)": (float(np.finfo(np.float32).tiny), 1.0)}


@pytest.mark.parametrize("interval", list(INTERVALS))
def test_float32_scaling_equals_the_float64_route_on_every_mantissa(interval):
    """Every interval the port draws from has a float32 span that is a
    power of two, where ``f * span + lo`` in float32 is the float64 route's
    (and XLA's fused multiply-add's) result for all 2^23 values of f."""
    minval, maxval = INTERVALS[interval]
    assert R.span_is_power_of_two(minval, maxval)
    f = torch.arange(1 << 23, dtype=torch.float32) * (1.0 / (1 << 23))
    lo = torch.full((), minval, dtype=torch.float32)
    hi = torch.full((), maxval, dtype=torch.float32)
    assert torch.equal(R._scale(f, lo, hi, True), R._scale(f, lo, hi, False))


def test_other_spans_keep_the_float64_route():
    """A span that is not a power of two (-2, 3), or none (an empty or
    subnormal one), is not taken by the float32 route."""
    for minval, maxval in ((-2.0, 3.0), (0.0, 3.0), (1.0, 1.0), (0.0, 1e-40)):
        assert not R.span_is_power_of_two(minval, maxval)


@pytest.mark.parametrize("draw", ["uniform", "bernoulli", "normal", "gumbel"])
def test_draws_make_no_float64_tensor(draw):
    """The op recorder sees no float64 output in the samplers a round
    program calls; the (-2, 3) uniform is the positive control."""
    from repro_torch.analysis.walker import iter_dtypes, record_ops
    key = R.PRNGKey(3, "cpu")
    calls = {"uniform": lambda: R.uniform(key, (64,)),
             "bernoulli": lambda: R.bernoulli(key, 0.3, (64,)),
             "normal": lambda: R.normal(key, (64,)),
             "gumbel": lambda: R.gumbel(key, (64,))}
    rec, _ = record_ops(calls[draw])
    assert "float64" not in set(iter_dtypes(rec))
    rec, _ = record_ops(lambda: R.uniform(key, (64,), minval=-2.0,
                                          maxval=3.0))
    assert "float64" in set(iter_dtypes(rec))
