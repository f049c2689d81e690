"""The CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the reference (the machine with the
card has no JAX), and skip where torch sees no CUDA device.  Run them
there without the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as R  # noqa: E402
from repro_torch.kernels.bwo_evolve import bwo_evolve as kernel_mod  # noqa: E402
from repro_torch.kernels.bwo_evolve import ops  # noqa: E402

GRID = [(4, 128), (8, 100), (16, 1000), (6, 4097)]
DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 2e-2)}


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
