"""Plain reference of the closed loop's start noise: the key chain the
sweep (``eval_closed_loop``) draws its episodes' starts from, in NumPy.

A key is two 32-bit words. ``root(seed)`` is the seed's high and low words;
``split(key)`` hashes the counts 0 and 1 under the key and gives two keys;
the sweep takes ``key, sub = split(key)`` once an episode and draws the
episode's unit-normal pose noise from ``sub``. Hash: Threefry-2x32 with 20
rounds (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC 2011), the counter-based generator JAX uses by default, with its
partitionable layout (a draw of n values hashes the counts 0 .. n-1).

The normal draw follows the sampler's definition: the top 23 bits of each
hash as the mantissa of a float32 in [1, 2), less one, scaled to
(nextafter(-1, 0), 1) and rounded once to float32; then sqrt(2) erfinv(u),
here in float64.
"""

from __future__ import annotations

import numpy as np
import torch

_M = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & _M


def threefry2x32(key, x0, x1):
    """The hash of the count pairs ``(x0, x1)`` (uint64 arrays of 32-bit
    words) under ``key`` (two words)."""
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M
    return x0, x1


def _hash_counts(key, n: int):
    i = np.arange(n, dtype=np.uint64)
    return threefry2x32(key, i >> np.uint64(32), i & _M)


def root(seed: int) -> np.ndarray:
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint64)


def split(key) -> tuple:
    """``(key, sub)``: the two keys split from ``key``."""
    b0, b1 = _hash_counts(key, 2)
    return (np.array([b0[0], b1[0]], np.uint64),
            np.array([b0[1], b1[1]], np.uint64))


def episode_keys(seed: int, n: int) -> list:
    """The first ``n`` episodes' keys of the chain rooted at ``seed``."""
    key, subs = root(seed), []
    for _ in range(n):
        key, sub = split(key)
        subs.append(sub)
    return subs


def normal(key, shape) -> np.ndarray:
    """Unit-normal draws of ``shape`` from ``key``, float64."""
    n = int(np.prod(shape))
    b0, b1 = _hash_counts(key, n)
    mant = ((b0 ^ b1) >> np.uint64(9)) | np.uint64(0x3F800000)
    floats = mant.astype(np.uint32).view(np.float32).astype(np.float64) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    # the product and the sum are exact in float64, so one cast rounds once
    u = np.maximum(lo, (floats * span + lo).astype(np.float32))
    z = np.sqrt(2.0) * torch.special.erfinv(
        torch.as_tensor(u.astype(np.float64))).numpy()
    return z.reshape(shape)
