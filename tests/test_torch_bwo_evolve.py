"""The bwo_evolve port: its plain version against the reference's oracle
on the same numpy inputs, the sampling wrapper against the reference's
Pallas kernel (interpret mode) under the same key, and the CPU/CUDA
dispatch.  The CUDA kernel itself is held against the plain version on
the card by test_torch_kernels_cuda.py.

Grid and tolerances as the reference's kernel tests: (P, D) in {(4,128),
(8,100), (16,1000), (6,4097)}, 1e-5 for float32, 2e-2 for bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bwo_evolve import ops as jops, ref as jref  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.kernels.bwo_evolve import bwo_evolve as kernel_mod  # noqa: E402
from repro_torch.kernels.bwo_evolve import ops, ref  # noqa: E402

GRID = [(4, 128), (8, 100), (16, 1000), (6, 4097)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def tkey(jkey):
    return R.as_key(np.asarray(jkey), "cpu")


def _inputs(P, D, seed, Dp=None):
    rng = np.random.default_rng(seed)
    Dp = D if Dp is None else Dp
    return dict(
        pop=rng.normal(size=(P, D)).astype(np.float32),
        p1=rng.integers(0, P, size=P).astype(np.int32),
        p2=rng.integers(0, P, size=P).astype(np.int32),
        b1=rng.integers(0, 2**32, size=(P, Dp), dtype=np.uint64).astype(np.uint32),
        b2=rng.integers(0, 2**32, size=(P, Dp), dtype=np.uint64).astype(np.uint32),
        gate=(rng.random((P, 1)) < 0.5).astype(np.float32))


def _ref_pair(x, jdt, tdt, **kw):
    want = jref.bwo_evolve_ref(jnp.asarray(x["pop"], jdt), jnp.asarray(x["p1"]),
                               jnp.asarray(x["p2"]), jnp.asarray(x["b1"]),
                               jnp.asarray(x["b2"]), jnp.asarray(x["gate"]), **kw)
    got = ref.bwo_evolve_ref(
        torch.as_tensor(x["pop"]).to(tdt), torch.as_tensor(x["p1"]),
        torch.as_tensor(x["p2"]), torch.as_tensor(x["b1"].view(np.int32)),
        torch.as_tensor(x["b2"].view(np.int32)), torch.as_tensor(x["gate"]), **kw)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("P,D", GRID)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_reference_oracle(P, D, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    want, got = _ref_pair(_inputs(P, D, P * 1000 + D), jdt, tdt,
                          pm_gene=0.1, mut_scale=0.05)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("P,D", GRID)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sampling_wrapper_matches_reference_kernel(P, D, dtype):
    """Same key: the reference's Pallas kernel (interpret mode) and the
    port's wrapper (plain version on the CPU) give the same children."""
    jdt, tdt, tol = DTYPES[dtype]
    jk = jax.random.PRNGKey(P * 1000 + D)
    pop = np.random.default_rng(D).normal(size=(P, D)).astype(np.float32)
    fit = np.random.default_rng(P).random(P).astype(np.float32)
    want = jops.bwo_evolve(jnp.asarray(pop, jdt), jnp.asarray(fit), jk,
                           interpret=True)
    got = ops.bwo_evolve(torch.as_tensor(pop).to(tdt), torch.as_tensor(fit),
                         tkey(jk))
    assert got.dtype == tdt and tuple(got.shape) == (P, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    ref_route = ops.bwo_evolve_reference(torch.as_tensor(pop).to(tdt),
                                         torch.as_tensor(fit), tkey(jk))
    assert torch.equal(ref_route, got)


@pytest.mark.parametrize("pm_gene,mut_scale", [(0.0, 0.1), (1.0, 0.0),
                                               (0.5, 0.2)])
def test_mutation_parameters(pm_gene, mut_scale):
    jk = jax.random.PRNGKey(7)
    pop = np.array(jax.random.normal(jk, (8, 256)))
    fit = np.arange(8.0, dtype=np.float32)
    want = jops.bwo_evolve(jnp.asarray(pop), jnp.asarray(fit), jk,
                           pm_gene=pm_gene, mut_scale=mut_scale, interpret=True)
    got = ops.bwo_evolve(torch.as_tensor(pop), torch.as_tensor(fit), tkey(jk),
                         pm_gene=pm_gene, mut_scale=mut_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_bits_are_drawn_at_the_padded_shape():
    """The threefry counter is the flat index: bits drawn at (P, D) are
    other bits than the reference's (P, Dp) draw, so the wrapper draws at
    (P, Dp) and the kernel reads Dp-strided rows."""
    P, D = 3, 100
    jk = jax.random.PRNGKey(11)
    _, _, jb1, _, _ = jax.random.split(jk, 5)
    want = np.asarray(jax.random.bits(jb1, (P, 128), jnp.uint32))
    pop32, _, _, b1, _, _ = ops.sample(torch.zeros(P, D), torch.zeros(P),
                                       tkey(jk), pm=0.4, procreate_frac=0.6)
    assert tuple(pop32.shape) == (P, D) and tuple(b1.shape) == (P, 128)
    assert b1.dtype == torch.int32
    assert (b1.numpy().view(np.uint32) == want).all()
    assert not (R.bits(tkey(jb1), (P, D)).numpy()
                == want[:, :D].astype(np.int64)).all()


def test_threshold_truncates_and_alpha_rounds_to_one():
    """int(pm_gene * 256) truncates (25 for 0.1), and bits1 = 2^32 - 1
    converts to 1.0 in float32, so the child is the mutated p1 itself."""
    x = _inputs(2, 64, 0)
    x["b2"][:] = np.arange(64, dtype=np.uint32)[None] % 32      # low byte 0..31
    x["b1"][:] = 0xFFFFFFFF
    x["gate"][:] = 1.0
    want, got = _ref_pair(x, jnp.float32, torch.float32, pm_gene=0.1,
                          mut_scale=0.5)
    np.testing.assert_array_equal(got, want)
    p1 = x["pop"][x["p1"]]
    mutated = got != p1
    assert mutated[:, (np.arange(64) % 32) < 25].all()
    assert not mutated[:, (np.arange(64) % 32) >= 25].any()


def test_cpu_tensors_take_the_plain_version():
    before = kernel_mod.launches
    P, D = 6, 300
    pop = torch.randn(P, D)
    out = ops.bwo_evolve(pop, torch.rand(P), R.PRNGKey(0, "cpu"))
    assert tuple(out.shape) == (P, D)
    assert kernel_mod.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel_mod.bwo_evolve_cuda(
            pop, torch.zeros(P, dtype=torch.int32),
            torch.zeros(P, dtype=torch.int32),
            torch.zeros(P, 384, dtype=torch.int32),
            torch.zeros(P, 384, dtype=torch.int32), torch.ones(P, 1),
            pm_gene=0.1, mut_scale=0.05)


def test_update_is_an_operator_torch_can_check():
    """``ops.evolve`` is a ``torch.library`` operator: its schema, fake
    (shape-only) kernel and CPU implementation pass ``opcheck``."""
    P, D = 6, 300
    pop = torch.randn(P, D)
    drawn = ops.sample(pop, torch.rand(P), R.PRNGKey(3, "cpu"), pm=0.4,
                       procreate_frac=0.6)
    torch.library.opcheck(ops.evolve, drawn,
                          dict(pm_gene=0.1, mut_scale=0.05))


@pytest.mark.parametrize("batched", ["all", "pop-shared"])
def test_vmapped_update_is_one_call_over_all_rows(monkeypatch, batched):
    """Under vmap over C clients the update runs once, over C * P rows
    with each client's parent indices offset by its first row, and equals
    C single updates bit for bit; an unbatched input (one population for
    every client's draws) is broadcast."""
    C, P, D = 4, 5, 130
    rows = []
    plain = ref.bwo_evolve_ref
    monkeypatch.setattr(ref, "bwo_evolve_ref", lambda pop, *a, **kw: (
        rows.append(tuple(pop.shape)), plain(pop, *a, **kw))[1])
    keys = R.split(R.PRNGKey(8, "cpu"), C)
    pops = torch.stack([R.normal(k, (P, D)) for k in keys])
    drawn = torch.func.vmap(lambda p, k: ops.sample(
        p, R.uniform(k, (P,)), k, pm=0.4, procreate_frac=0.6))(pops, keys)
    kw = dict(pm_gene=0.1, mut_scale=0.05)
    if batched == "pop-shared":
        drawn = (pops[0],) + drawn[1:]
        got = torch.func.vmap(lambda *a: ops.evolve(*a, **kw),
                              in_dims=(None, 0, 0, 0, 0, 0))(*drawn)
        want = torch.stack([ops.evolve(drawn[0], *(t[c] for t in drawn[1:]),
                                       **kw) for c in range(C)])
    else:
        got = torch.func.vmap(lambda *a: ops.evolve(*a, **kw))(*drawn)
        want = torch.stack([ops.evolve(*(t[c] for t in drawn), **kw)
                            for c in range(C)])
    assert rows[0] == (C * P, D) and len(rows) == 1 + C
    assert torch.equal(got, want)
