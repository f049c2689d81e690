"""Counter-based random numbers that reproduce ``jax.random`` draw for draw.

The port's counterpart of the ``jax.random`` calls on the FedBWO path:
threefry2x32 (Salmon et al. 2011) with JAX's *partitionable* layout
(``jax_threefry_partitionable=True``, the default since jax 0.5), in which
element ``i`` of a draw of any shape hashes the 64-bit counter ``i`` — its
high word and its low word — under the key, and 32-bit ``bits`` are the
XOR of the two output words.  ``split`` hashes the counters ``0..n-1`` and
keeps both words as the new keys.

A key is a 2-word int64 tensor ``[k_hi, k_lo]`` on the caller's device;
every word holds an unsigned 32-bit value.  The plain route's arithmetic
works in int64 and masks to 32 bits.  Draws are returned on the key's
device.

Each sampler mirrors the ``jax/_src/random.py`` function of the same name
(jax 0.9.0): ``uniform`` builds floats from the top mantissa bits,
``randint`` combines two bit draws, ``normal`` maps a uniform through
``erfinv`` (the one place the port differs from XLA in the last bits),
``permutation`` sorts by fresh 32-bit keys ``ceil(3 ln n / ln(2^32 - 1))``
times, ``choice`` without replacement takes a permutation's prefix, and
``categorical`` is the Gumbel-max trick over ``gumbel`` (mode "low").

On a CUDA key each sized draw and each ``split`` is one launch of the
threefry kernel (``repro_torch.kernels.threefry``, ``csrc/threefry.cu``),
which hashes the counters and maps them to the sampler's bits, uniforms,
normals or booleans in registers: the same words as the int64 route, which
stays as the plain version on the CPU (and on the meta device, which draws
nothing).  On the CPU a draw of more than ``PIECE`` elements is made piece
by piece over disjoint counter ranges into one preallocated output, which
gives the same values element for element and bounds the int64
temporaries by the piece, not the draw (a stack of experts is over a
billion elements).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch import spans

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]

PIECE = 1 << 26              # counters hashed at once by a large CPU draw


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _words(key: torch.Tensor):
    """The key's two words as int64 scalars (0-dim tensors)."""
    key = key.to(torch.int64) & MASK
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor, got shape {tuple(key.shape)}")
    return key[0], key[1]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words ``(x1, x2)`` under
    key words ``(k1, k2)``; all int64 tensors holding 32-bit values,
    broadcast together.  Returns the two output words (only their shape
    and type on the meta device)."""
    if x1.device.type == "meta":
        shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
        return (x1.new_empty(shape), x1.new_empty(shape))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash_iota(key, n: int, start: int = 0):
    """Both output words for the counters start..start+n-1 under ``key``."""
    k1, k2 = _words(key)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def _i32(bits: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the int32 words of the same
    bits."""
    return (bits - ((bits >> 31) << 32)).to(torch.int32)


def _kernel(key: torch.Tensor, start: int, n: int, kind: str,
            **params) -> torch.Tensor:
    """The counters start..start+n-1 of a draw of ``kind`` under a CUDA
    key: one launch of the threefry kernel, inside a ``threefry_kernel``
    span counting the counters it hashed."""
    from repro_torch.kernels.threefry import ops
    with spans.span("threefry_kernel", n):
        return ops.draw(key, start, n, kind, **params)


def fill(key: torch.Tensor, shape: Shape, draw, dtype) -> torch.Tensor:
    """A draw of ``shape`` in ``dtype``, where ``draw(start, n)`` gives the
    values of the flat counters start..start+n-1.  On a CUDA key, or up to
    ``PIECE`` elements, it is one call; above, on the CPU, each piece of
    ``PIECE`` counters is drawn, cast and written into one preallocated
    output.  On the meta device (trees of shapes only) nothing is drawn.
    Every sized draw of a round goes through here: inside a recorded block
    it is a ``threefry`` span (``repro_torch.spans``) counting the counters
    hashed."""
    shape = _shape(shape)
    if key.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    n = math.prod(shape)
    with spans.span("threefry", n):
        if n <= PIECE or key.device.type == "cuda":
            return draw(0, n).to(dtype).reshape(shape)
        out = torch.empty(n, dtype=dtype, device=key.device)
        for start in range(0, n, PIECE):
            m = min(PIECE, n - start)
            out[start:start + m] = draw(start, m)
        return out.reshape(shape)


def PRNGKey(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed split into two words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def as_key(key, device) -> torch.Tensor:
    """A key from anything array-like (a JAX key through ``np.asarray``,
    a list of two words), as an int64 tensor on ``device``."""
    t = torch.as_tensor(np.array(key), device=device)
    return t.to(torch.int64) & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: a (num, 2) tensor of new keys."""
    if key.device.type == "cuda":
        from repro_torch.kernels.threefry import ops
        return ops.draw(key, 0, num, "pairs")
    y1, y2 = _hash_iota(key, num)
    return torch.stack([y1, y2], dim=1)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: unsigned 32-bit values held
    in an int64 tensor.  The counter is the flat row-major index, so the
    same key gives other bits at another shape."""
    return fill(key, shape, lambda start, n: _bits_any(key, start, n),
                torch.int64)


def bits32(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``bits`` as int32 words (the same 32 bits, as a kernel reads them):
    on a CUDA key the kernel's words, with no int64 in between."""
    cuda = key.device.type == "cuda"
    return fill(key, shape, lambda start, n: (
        _kernel(key, start, n, "bits") if cuda
        else _i32(_bits_at(key, start, n))), torch.int32)


def _bits_any(key, start: int, n: int):
    """``_bits_at`` on any device: the kernel's words widened on a CUDA
    key."""
    if key.device.type == "cuda":
        return _kernel(key, start, n, "bits").to(torch.int64) & MASK
    return _bits_at(key, start, n)


def _bits_at(key, start: int, n: int):
    y1, y2 = _hash_iota(key, n, start)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), less 1, scaled to [minval, maxval)."""
    if dtype != torch.float32:
        raise NotImplementedError(f"uniform is ported for float32, got {dtype}")
    exact = span_is_power_of_two(minval, maxval)
    if exact and key.device.type == "cuda":
        return fill(key, shape, lambda start, n: _kernel(
            key, start, n, "uniform", lo=minval, hi=maxval), dtype)
    # filled on the device: a tensor built from a host scalar is a copy
    # from pageable memory and a sync, which a CUDA graph capture refuses
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return fill(key, shape, lambda start, n: _uniform_of(
        _bits_any(key, start, n), lo, hi, exact), dtype)


def span_is_power_of_two(minval: float, maxval: float) -> bool:
    """Whether the float32 span ``maxval - minval`` (as XLA computes it) is
    a normal power of two: then ``f * span`` is exact in float32 for every
    ``f = m * 2^-23`` that ``uniform`` makes.  Decided on the host."""
    span = np.float32(maxval) - np.float32(minval)
    return bool(np.isfinite(span) and span >= np.finfo(np.float32).tiny
                and np.frexp(span)[0] == 0.5)


def _uniform_at(key, start: int, n: int, lo, hi, exact: bool):
    return _uniform_of(_bits_at(key, start, n), lo, hi, exact)


def _uniform_of(b, lo, hi, exact: bool):
    # the float in [1, 2) with mantissa m = b >> 9, less 1, is m * 2^-23
    # exactly; computed so, not by a bit cast, since older torch has no
    # vmap rule for a dtype view
    f = (b >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return torch.maximum(lo, _scale(f, lo, hi, exact))


def _scale(f, lo, hi, exact: bool):
    """``f * (hi - lo) + lo`` as XLA computes it: contracted into one fused
    multiply-add.  With a power-of-two span (``exact``) the float32 product
    is exact, so the add's one rounding is the FMA's.  Any other span keeps
    the product in float64, where the product of two float32 values is
    exact, and rounds once at the end (barring a double-rounding tie); the
    port's round programs draw from no such span and stay float32."""
    if exact:
        return f * (hi - lo) + lo
    return (f.double() * (hi - lo).double() + lo.double()).float()


def bernoulli(key: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` in float32
    (on a CUDA key the kernel compares in registers)."""
    if key.device.type == "cuda":
        return fill(key, shape, lambda start, n: _kernel(
            key, start, n, "bernoulli", p=p), torch.bool)
    return uniform(key, shape) < torch.full((), p, dtype=torch.float32,
                                            device=key.device)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32: two bit draws, reduced modulo the
    span in uint32 arithmetic (wrapping as JAX's does)."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError("randint is ported for int32 bounds")
    k = split(key)
    hi, lo = bits(k[0], shape), bits(k[1], shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = ((2**16 % span) ** 2 & MASK) % span   # wraps to 0 for span > 2^16
    off = ((hi % span) * mult & MASK) + lo % span
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems, 2011), the polynomial XLA lowers float32 erf_inv to; the
# two coefficient sets are for w < 5 and w >= 5, highest degree first.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _residual(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """w - y * y, with y * y taken exactly as a float32 sum p + e (Dekker's
    product, Veltkamp's split at 2^12 + 1): w - p is exact where p is near
    w, so one rounding remains."""
    c = y * 4097.0
    hi = c - (c - y)
    lo = y - hi
    p = y * y
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return (w - p) - e


def _sqrt_cpu(w: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as XLA's, from float32 products and
    sums alone: w * rsqrt(w), one Newton step on the exact residual, then
    the float below or above taken where w lies past the midpoint with it
    (every float32 in [1e-6, 1000) checked against numpy's sqrt).  The CPU
    route's ``torch.sqrt`` goes through MKL's vector sqrt, which misses the
    correctly rounded value by an ulp on ~0.6 % of inputs and, in a fresh
    process at torch's default thread count, has rounded one worker
    thread's first 16,384-element chunk to ~12 bits (3 runs in 80)."""
    y = w * torch.rsqrt(w)
    y = y + _residual(w, y) / (y + y)
    r = _residual(w, y)
    down = y - torch.nextafter(y, torch.zeros_like(y))
    up = torch.nextafter(y, torch.full_like(y, math.inf)) - y
    below = r + y * down - 0.25 * down * down < 0     # w < (y - down/2)^2
    above = r - y * up - 0.25 * up * up > 0           # w > (y + up/2)^2
    return torch.where(below, y - down, torch.where(above, y + up, y))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    root = _sqrt_cpu(w) if w.device.type == "cpu" else torch.sqrt(w)
    w = torch.where(lt, w - 2.5, root - 3.0)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1, x * math.inf, p * x)


# the float32 next after -1 towards 0: the low end of normal's uniform
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_NORMAL_EXACT = span_is_power_of_two(_NORMAL_LO, 1.0)   # the span rounds to 2


def normal(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erfinv(u) with u uniform on
    (nextafter(-1, 0), 1).  ``torch.log1p`` and XLA's differ in the last
    bit, so a draw agrees with JAX's within 1e-6, not exactly."""
    if dtype != torch.float32:
        raise NotImplementedError(f"normal is ported for float32, got {dtype}")
    return fill(key, shape, lambda start, n: normal_at(key, start, n), dtype)


def normal_at(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Elements start..start+n-1 of any flat float32 ``normal`` draw under
    ``key``: the piece ``fill`` asks for (on a CUDA key, the kernel's)."""
    if key.device.type == "cuda":
        return _kernel(key, start, n, "normal", lo=_NORMAL_LO, hi=1.0)
    lo = torch.full((), _NORMAL_LO, dtype=torch.float32, device=key.device)
    hi = torch.full((), 1.0, dtype=torch.float32, device=key.device)
    return _normal_of(_uniform_at(key, start, n, lo, hi, _NORMAL_EXACT))


def _normal_of(u: torch.Tensor) -> torch.Tensor:
    """sqrt(2) * erfinv(u) in float32."""
    return _erfinv(u) * torch.full((), math.sqrt(2.0), dtype=torch.float32,
                                   device=u.device)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: stable sorts of ``arange(n)`` by
    fresh 32-bit keys, ``ceil(3 ln n / ln(2^32 - 1))`` rounds (int64)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(bits(sub, (n,)), stable=True)
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the prefix of a
    permutation (sampling with replacement is not on the ported path)."""
    shape = _shape(shape)
    draws = math.prod(shape)
    if draws > n:
        raise ValueError(f"cannot take {draws} of {n} without replacement")
    return permutation(key, n)[:draws].reshape(shape)


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default mode "low":
    ``-log(-log(u))`` with u uniform on [tiny, 1).  ``torch.log`` and
    XLA's may differ in the last bit."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` with replacement and
    the default shape: the argmax of logits plus Gumbel noise drawn at the
    logits' shape (int64 indices)."""
    return torch.argmax(gumbel(key, logits.shape, logits.dtype) + logits,
                        dim=axis)
