"""The error model of flash attention's ``tf32x3`` route, emulated on the CPU.

The route's kernels (``csrc/flash_attention_tf32.cu``,
``csrc/flash_attention_bwd_tf32.cu``) take every float32 product a b on the
tensor cores as hi_a hi_b + hi_a lo_b + lo_a hi_b into an fp32
accumulator, hi = tf32(x) and lo = tf32(x - hi).  The kernels pass x itself
as hi and the exact remainder as lo: the tensor cores read a float32
operand's top 19 bits, so both parts are cut toward zero ("cut").  The
other split rounds both to nearest ("nearest", cvt.rna.tf32.f32).  Here
tf32 is emulated on the int32 view (nearest: add 0x1000 and clear the low
13 bits; cut: clear them), the tf32 products are exact in float32 and
summed in float32, and the attention and its gradient built from them are
held to float64 at a reduced Whisper-like shape: within the float32
limits the card's results are held to (2e-5 on the output, 1e-4 of each
gradient's largest entry) with three products, and outside them with one,
for either split.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

B, S, H, HD = 1, 256, 2, 64
OUT_TOL, GRAD_TOL = 2e-5, 1e-4


def tf32(x, rounding):
    """float32 to tf32's 10 mantissa bits: to nearest (ties away from
    zero), or cut toward zero."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def split(x, rounding):
    hi = tf32(x, rounding)
    return hi, tf32(x - hi, rounding)


def matmul(a, b, terms, rounding):
    """a @ b over the last two axes as the tensor cores take it: 3 (hi hi +
    hi lo + lo hi, small terms first) or 1 (hi hi) tf32 products."""
    ah, al = split(a, rounding)
    bh, bl = split(b, rounding)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def attention(q, k, v, do, terms, rounding):
    """Forward and gradient of softmax(q k^T * scale) v, (B, H, S, hd),
    every product through ``matmul``; fp32 elsewhere, as the kernels."""
    def mm(a, b):
        return matmul(a, b, terms, rounding)

    scale = HD ** -0.5
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = mm(p, v)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    dv = mm(p.transpose(-1, -2), do)
    return o, (dq, dk, dv)


def inputs():
    rng = np.random.default_rng(1500)
    return [torch.from_numpy(rng.standard_normal((B, H, S, HD), np.float32))
            for _ in range(4)]


def float64_reference(q, k, v, do):
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) * HD ** -0.5
    o = torch.softmax(s, dim=-1) @ leaves[2]
    return o.detach(), torch.autograd.grad(o, leaves, do.double())


def errors(terms, rounding):
    q, k, v, do = inputs()
    o, grads = attention(q, k, v, do, terms, rounding)
    o64, grads64 = float64_reference(q, k, v, do)
    out_err = (o.double() - o64).abs().max().item()
    grad_errs = [((g.double() - w).abs().max()
                  / max(1.0, w.abs().max().item())).item()
                 for g, w in zip(grads, grads64)]
    return out_err, grad_errs


@pytest.mark.parametrize("rounding,want", [
    ("nearest", [1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -9), 3.0]),
    ("cut", [1.0, 1.0, -(1.0 + 2 ** -10), 3.0]),
])
def test_tf32_keeps_ten_bits(rounding, want):
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11),
                      3.0], dtype=torch.float32)
    assert torch.equal(tf32(x, rounding), torch.tensor(want))
    hi, lo = split(x, rounding)
    assert torch.equal(hi + lo, x)          # exact for these


@pytest.mark.parametrize("rounding", ["nearest", "cut"])
def test_three_tf32_products_keep_float32_limits(rounding):
    out_err, grad_errs = errors(3, rounding)
    assert out_err <= OUT_TOL, out_err
    assert max(grad_errs) <= GRAD_TOL, grad_errs


@pytest.mark.parametrize("rounding", ["nearest", "cut"])
def test_one_tf32_product_misses_them(rounding):
    out_err, grad_errs = errors(1, rounding)
    assert out_err > OUT_TOL, out_err
    assert max(grad_errs) > GRAD_TOL, grad_errs
