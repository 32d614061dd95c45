"""The JAX package's random numbers, reproduced bit for bit in numpy.

GrabCut's k-means++ seeding draws Gumbel noise from ``jax.random`` under a
fixed key (``gcn_grabcut_tpu/ops/gmm.py``: ``PRNGKey(seed)``, one
``split`` per draw, ``gumbel`` over the pixels).  The noise depends only
on the seed, the draw and the pixel count, so the port computes the same
bits here: the Threefry-2x32 hash (20 rounds), JAX's partitionable
``split`` and ``random_bits`` (counters are the flat index as a 64-bit
iota), ``uniform`` from the top 23 bits, and ``gumbel``'s default mode,
-log(-log(u)).  Same keys, same bits, so the same centres are drawn and
GrabCut starts from the JAX package's components.
"""

from __future__ import annotations

import functools

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the counter pairs (x1, x2) under the key (k1, k2),
    as ``jax._src.prng._threefry2x32_lowering``."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def split(key: tuple) -> tuple:
    """``jax.random.split(key)`` -> (new key, subkey)."""
    b1, b2 = threefry2x32(*key, np.zeros(2, np.uint32),
                          np.arange(2, dtype=np.uint32))
    return (b1[0], b2[0]), (b1[1], b2[1])


def uniform(key: tuple, n: int, minval: float) -> np.ndarray:
    """``jax.random.uniform(key, (n,), minval=minval, maxval=1.0)`` in
    float32: 23 random mantissa bits under exponent 0, minus 1."""
    b1, b2 = threefry2x32(*key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.float32(minval)
    return np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)


def gumbel(key: tuple, n: int) -> np.ndarray:
    """``jax.random.gumbel(key, (n,))`` in float32 (mode "low"): the same
    uniform bits; the two logs may round differently in the last place."""
    u = uniform(key, n, minval=np.finfo(np.float32).tiny)
    return -np.log(-np.log(u))


@functools.lru_cache(maxsize=8)
def kmeans_pp_noise(seed: int, n: int, draws: int) -> np.ndarray:
    """(draws, n) read-only Gumbel noise of the JAX package's k-means++
    under ``PRNGKey(seed)``: draw i uses the subkey of the i-th split."""
    key = (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))
    out = np.empty((draws, n), np.float32)
    for i in range(draws):
        key, sub = split(key)
        out[i] = gumbel(sub, n)
    out.flags.writeable = False
    return out
