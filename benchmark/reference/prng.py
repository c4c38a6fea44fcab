"""Threefry-2x32 draws in numpy, as ``jax.random`` makes them with
``jax_threefry_partitionable`` on.

A frozen copy of the arithmetic the system under test derives its crops,
permutations and dropout masks from, written again in numpy (uint64
words masked to 32 bits) so that the reference works its random inputs
out from the seed by itself.  A key is a ``(2,)`` uint32 array.
"""

from __future__ import annotations

import hashlib

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint64(0x1BD11BDA)


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _MASK


def threefry_2x32(k1, k2, x1, x2):
    """The 20-round hash of the counter pairs ``(x1, x2)`` (uint64 arrays
    holding 32-bit words) under the key words ``k1, k2``."""
    k1, k2 = np.uint64(k1), np.uint64(k2)
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _MASK
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` with 64-bit mode off: ``[0, seed mod
    2**32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _iota(k: np.ndarray, n: int):
    count = np.arange(n, dtype=np.uint64)
    return threefry_2x32(k[0], k[1], count >> np.uint64(32), count & _MASK)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` keys."""
    hi, lo = _iota(k, num)
    return np.stack([hi, lo], axis=-1).astype(np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    hi, lo = threefry_2x32(k[0], k[1], np.zeros(1, np.uint64),
                           np.array([int(data) & 0xFFFFFFFF], np.uint64))
    return np.concatenate([hi, lo]).astype(np.uint32)


def fold_in_static(k: np.ndarray, *data) -> np.ndarray:
    """Flax's ``_fold_in_static``: the first four bytes of the SHA-1 of
    the strings and ints in ``data``, folded into ``k``."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8,
                                     byteorder="big"))
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    hi, lo = _iota(k, n)
    return (hi ^ lo).astype(np.uint32)


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``(n,)`` float32 in ``[0, 1)``: the top 23 bits as a mantissa."""
    bits = random_bits(k, n)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def bernoulli(k: np.ndarray, p: float, n: int) -> np.ndarray:
    return uniform(k, n) < np.float32(p)


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: stable sorts of ``arange(n)`` by
    32 random bits, ``ceil(3 ln n / ln(2**32 - 1))`` rounds."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x
