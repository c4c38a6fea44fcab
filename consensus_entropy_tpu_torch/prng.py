"""Threefry-2x32 counter-based PRNG, bit-equal with ``jax.random``.

The port's counterpart of the JAX threefry implementation
(``jax/_src/prng.py``: ``threefry_2x32``, ``_threefry_seed``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_bernoulli``, ``_shuffle``) under
``jax_threefry_partitionable=True``,
the setting the JAX package runs with.  Draws depend on the key and on each
element's flat index only, so they do not depend on the device.

A key is a ``(2,)`` ``torch.uint32`` tensor, the same words as
``jax.random.key_data`` of the JAX key; a batch of keys is ``(..., 2)``.
torch's uint32 arithmetic is partial (on CUDA above all), so the rounds run
in int64 holding uint32 values, masked after every add and shift, and keys
cross between the two by reinterpreting as int32.
"""

from __future__ import annotations

import hashlib
import math
import operator
from collections.abc import Sequence

import numpy as np
import torch

from consensus_entropy_tpu_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key words ``(k1, k2)``: 20 rounds, a key injection after every four.
    All operands are int64 tensors holding uint32 values (the key words
    may be 0-dim tensors or Python ints); returns the two output words,
    same dtype and shape."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _words(key: torch.Tensor) -> torch.Tensor:
    """uint32 key data -> int64 words in ``[0, 2**32)``."""
    if key.dtype != torch.uint32 or key.shape[-1:] != (2,):
        raise TypeError(f"expected a (..., 2) uint32 key, got {key.dtype} "
                        f"{tuple(key.shape)}")
    return key.view(torch.int32).to(torch.int64) & _MASK


def _to_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` -> uint32 (through int32's wrap)."""
    return words.to(torch.int32).view(torch.uint32)


def _shape(shape) -> tuple:
    return tuple(shape) if isinstance(shape, Sequence) else (int(shape),)


def _hash_iota(key: torch.Tensor, shape: tuple, device):
    """Both hash words of the 64-bit row-major counter over ``shape``
    (``iota_2x32_shape``: high word, low word)."""
    words = _words(key)
    if words.shape != (2,):
        raise TypeError(f"expected a single (2,) key, got {tuple(key.shape)}")
    dev = key.device if device is None else resolve_device(device)
    if words.device == dev:
        k1, k2 = words[0], words[1]
    else:
        # a key on another device enters the rounds as Python ints: a
        # pageable copy to the card would wait for its queue to drain
        k1, k2 = words.tolist()
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    hi, lo = threefry_2x32(k1, k2, count >> 32, count & _MASK)
    return hi.reshape(shape), lo.reshape(shape)


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data.  With 64-bit mode off (as the JAX
    package runs) a Python int seed goes through int32 first, so the high
    word is 0 and the low word is the seed modulo ``2**32`` (``-1`` gives
    ``[0, 0xFFFFFFFF]``, ``2**40 + 3`` gives ``[0, 3]``)."""
    seed = operator.index(seed)
    return _to_uint32(torch.tensor([0, seed & _MASK], dtype=torch.int64,
                                   device=resolve_device(device)))


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split``: ``num`` (an int or a shape) new keys,
    ``(*shape, 2)``."""
    shape = _shape(num)
    hi, lo = _hash_iota(key, shape, None)
    return _to_uint32(torch.stack([hi, lo], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``,
    ``data`` taken as uint32."""
    words = _words(key)
    data = torch.full((1,), operator.index(data) & _MASK, dtype=torch.int64,
                      device=key.device)
    hi, lo = threefry_2x32(words[0], words[1], torch.zeros_like(data), data)
    return _to_uint32(torch.cat([hi, lo]))


def key_data(keys: torch.Tensor) -> torch.Tensor:
    """The uint32 words of ``keys`` (a port key already is its data)."""
    _words(keys)
    return keys


def wrap_key_data(data, device=None) -> torch.Tensor:
    """A key (batch) from ``(..., 2)`` uint32 words: a tensor stays on its
    device unless ``device`` is given; anything else (numpy, a JAX key's
    ``key_data``, nested lists) goes to ``device``."""
    if isinstance(data, torch.Tensor):
        out = data if device is None else data.to(resolve_device(device))
    else:
        words = np.asarray(data, dtype=np.uint32)
        out = torch.from_numpy(words.view(np.int32).copy()).view(
            torch.uint32).to(resolve_device(device))
    _words(out)
    return out


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 uniform random bits per element of ``shape`` (uint32), the
    partitionable path: the XOR of the two hash words of each element's
    flat index.  Drawn on the key's device, or on ``device``."""
    hi, lo = _hash_iota(key, _shape(shape), device)
    return _to_uint32(hi ^ lo)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` on ``[0, 1)`` in float32: the top 23 random
    bits as the mantissa of a float in ``[1, 2)``, minus 1 (JAX
    ``_uniform``).  Other ranges are not ported: XLA fuses their scale and
    shift into one multiply-add, which torch does not promise."""
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 only, got {dtype}")
    hi, lo = _hash_iota(key, _shape(shape), device)
    return ((((hi ^ lo) >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


def bernoulli(key: torch.Tensor, p=0.5, shape=None,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode ``'low'``): ``uniform < p``, boolean,
    of ``shape`` (default: ``p``'s shape)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    u = uniform(key, shape, device=device)
    return u < p.to(u.device)


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (JAX ``_shuffle``): rounds of
    ``key, sub = split(key)`` and a stable sort of ``arange(n)`` by 32 random
    bits of ``sub`` each; ``ceil(3 ln n / ln(2**32 - 1))`` rounds, one up to
    n = 1625, two up to about 2.6 million.  int64, on the key's device or
    on ``device``."""
    dev = key.device if device is None else resolve_device(device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(
        np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        bits = random_bits(sub, (n,), dev).view(torch.int32).to(
            torch.int64) & _MASK
        x = x[torch.sort(bits, stable=True).indices]
    return x


def fold_in_static(key: torch.Tensor, *data) -> torch.Tensor:
    """Flax's ``_fold_in_static`` (``flax/core/scope.py:110-140``): the
    SHA-1 of the strings (UTF-8) and ints (big-endian, minimal bytes) in
    ``data``, its first four bytes folded into ``key``.  Flax's
    ``make_rng`` derives a module's key this way from its path and call
    counter: ``Dropout_0``'s first draw under a ``dropout`` key ``k`` is
    ``fold_in_static(k, "Dropout_0", 1)`` (``flax_fix_rng_separator`` off,
    Flax's default)."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))
