"""Counter-based random numbers of ``jax.random`` (threefry2x32, the
partitionable layout), written from the published algorithm for the plain
reference.

A key is a pair of Python ints ``(hi, lo)``, each an unsigned 32-bit word.
Element ``i`` of a draw of any shape hashes the 64-bit counter ``i`` (its
high and its low word) under the key; 32-bit ``bits`` are the XOR of the
two output words, and ``split`` keeps both words of the counters
``0..n-1`` as the new keys.  Small draws run on the host in numpy, large
ones on a torch device; the hash is the same integer arithmetic on both
(int64 values masked to 32 bits).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def key_from_seed(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as two words."""
    seed = int(seed)
    return ((seed >> 32) & MASK, seed & MASK)


def hash2x32(k1, k2, x1, x2):
    """threefry2x32, 20 rounds, of counter words ``(x1, x2)`` under key
    words ``(k1, k2)``: ints, numpy int64 arrays or torch int64 tensors,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) | (x2 >> (32 - r))) & MASK) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _counters(n: int, device=None):
    if device is None:
        idx = np.arange(n, dtype=np.int64)
    else:
        idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key, num: int = 2) -> list:
    """``jax.random.split``: ``num`` new keys."""
    hi, lo = _counters(num)
    y1, y2 = hash2x32(key[0], key[1], hi, lo)
    return [(int(a), int(b)) for a, b in zip(y1, y2)]


def bits(key, shape, device=None):
    """``jax.random.bits(key, shape, uint32)`` as int64 values: numpy on
    the host (``device`` None) or a torch tensor on ``device``."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), device)
    y1, y2 = hash2x32(key[0], key[1], hi, lo)
    return (y1 ^ y2).reshape(shape)


def unit_float(b):
    """The top 23 bits of each word as the float32 ``m * 2^-23`` in [0, 1)
    (``jax.random.uniform``'s mantissa trick, before scaling)."""
    if isinstance(b, np.ndarray):
        return (b >> 9).astype(np.float32) * np.float32(2.0 ** -23)
    return (b >> 9).to(torch.float32) * (2.0 ** -23)


def uniform(key, shape, device=None):
    """``jax.random.uniform`` on [0, 1), float32."""
    return unit_float(bits(key, shape, device))


def bernoulli(key, p: float, shape, device=None):
    """``jax.random.bernoulli``: ``uniform < p`` in float32."""
    return uniform(key, shape, device) < np.float32(p)


NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key, shape, device, dtype=torch.float64):
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1) built in float32 as JAX builds it (the span
    rounds to 2, so ``2 f + lo`` rounds once), and erfinv taken in
    ``dtype``."""
    f = uniform(key, shape, device)
    u = torch.maximum(f * 2.0 + NORMAL_LO,
                      torch.tensor(NORMAL_LO, dtype=torch.float32,
                                   device=device))
    return torch.erfinv(u.to(dtype)) * math.sqrt(2.0)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` for int32 bounds, on the host: two bit draws
    reduced modulo the span in uint32 arithmetic."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = ((hi % span) * mult & MASK) + lo % span
    return ((off & MASK) % span + minval).astype(np.int64)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: stable sorts of ``arange(n)`` by
    fresh 32-bit keys, ``ceil(3 ln n / ln(2^32 - 1))`` rounds."""
    x = np.arange(n)
    for _ in range(math.ceil(3 * math.log(max(1, n)) / math.log(MASK))):
        key, sub = split(key)
        x = x[np.argsort(bits(sub, (n,)), kind="stable")]
    return x
