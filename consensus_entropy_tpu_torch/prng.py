"""Threefry-2x32 counter-based PRNG, bit-equal with ``jax.random``.

The port's counterpart of the JAX threefry implementation
(``jax/_src/prng.py``: ``threefry_2x32``, ``_threefry_seed``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_bernoulli``, ``_shuffle``, ``_truncated_normal``) under
``jax_threefry_partitionable=True``, the setting the JAX package runs
with.  Draws depend on the key and on each element's flat index only, so
they do not depend on the device.  ``truncated_normal`` (Flax's LeCun-
normal initialization) also reproduces XLA's float32 ``erf_inv`` on the
CPU, with its contracted multiply-adds taken in float64.

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


def _floats(bits: torch.Tensor) -> torch.Tensor:
    """int64 random bits -> float32 in ``[0, 1)``: the top 23 bits as the
    mantissa of a float in ``[1, 2)``, minus 1 (JAX ``_uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


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
            device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (JAX ``_uniform``): the top 23
    random bits as the mantissa of a float in ``[1, 2)``, minus 1, then
    ``max(minval, floats * (maxval - minval) + minval)``.  XLA fuses that
    multiply-add into one rounding (an FMA), so it is taken in float64 and
    rounded once; on ``[0, 1)`` it changes nothing."""
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 only, got {dtype}")
    hi, lo = _hash_iota(key, _shape(shape), device)
    floats = _floats(hi ^ lo)
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo_, span = np.float32(minval), np.float32(maxval) - np.float32(minval)
    return torch.clamp(_fma(floats, float(span), float(lo_)),
                       min=float(lo_))


def uniform_rows(keys: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``(U, n)`` float32: row ``u`` is ``uniform(keys[u], (n,))`` bit for
    bit (``jax.vmap`` of the draw over a ``(U, 2)`` key batch), drawn in
    one pass on the keys' device or on ``device``."""
    words = _words(keys)
    if words.dim() != 2:
        raise TypeError(f"expected a (U, 2) key batch, got "
                        f"{tuple(keys.shape)}")
    dev = keys.device if device is None else resolve_device(device)
    words = words.to(dev)
    count = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    hi, lo = threefry_2x32(words[:, :1], words[:, 1:], count >> 32,
                           count & _MASK)
    return _floats(hi ^ lo)


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA's contracted
    multiply-add on the CPU: float32 products are exact in float64."""
    def f64(t):
        return t.double() if isinstance(t, torch.Tensor) else t
    return (f64(a) * f64(b) + f64(c)).float()


#: Cephes' float32 log polynomial (XLA's own ``log`` on the CPU)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
#: Cephes' log1p rational approximation for ``|x| < sqrt(2) - 1``
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: Giles' float32 erf_inv polynomials, for ``w < 5`` and ``w >= 5``
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def _log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU for positive normal ``v``: the
    mantissa shifted to ``[sqrt(1/2), sqrt(2))``, Cephes' polynomial in
    three parts, its multiply-adds contracted as LLVM does there."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7E).to(torch.float32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    shift = m < _f32(0.707106781186547524)
    x = torch.where(shift, (m - 1.0) + m, m - 1.0)
    e = torch.where(shift, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    c = [_f32(p) for p in _LOG_P]
    y = _fma(_fma(c[0], x, c[1]), x, c[2])
    y1 = _fma(_fma(c[3], x, c[4]), x, c[5])
    y2 = _fma(_fma(c[6], x, c[7]), x, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1) * e)
    return _fma(_f32(_LOG_Q2), e, _fma(-0.5, x2, x) + y)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU, for ``x > -1``: Cephes'
    rational approximation below ``|x| = sqrt(2) - 1``, ``log(1 + x)``
    above."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_NUM)
                                         / _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _log_xla(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on the CPU (Giles' polynomials in
    ``w = -log1p(-x * x)``): bit for bit over truncated_normal's range
    ``|x| <= erf(sqrt 2)``, within one ulp on the rest of (-1, 1), where
    a float64-emulated multiply-add can round otherwise than the
    contracted one.  ``torch.erfinv`` differs from it in two entries of
    three."""
    w = -_log1p_xla(-x * x)
    lt5 = w < 5.0
    w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt5, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt5, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


#: ``erf(bound / sqrt(2))`` in float32 as XLA computes it, for the bounds
#: ``truncated_normal`` takes (bits 0x3F745A18 for 2; the tests pin them):
#: ``torch.erf`` may differ from XLA's by an ulp
ERF_OF_BOUND = {2.0: 0.9544997, -2.0: -0.9544997}


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape=(), device=None) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32: a uniform draw between
    ``erf(lower / sqrt 2)`` and ``erf(upper / sqrt 2)``, ``sqrt(2) *
    erf_inv`` of it, clipped to the open interval ``(lower, upper)``.
    The bounds are those of :data:`ERF_OF_BOUND` (LeCun-normal
    initialization truncates at two deviations)."""
    try:
        a, b = ERF_OF_BOUND[float(lower)], ERF_OF_BOUND[float(upper)]
    except KeyError:
        raise ValueError(f"truncated_normal bounds must be among "
                         f"{sorted(ERF_OF_BOUND)}, got ({lower}, {upper})"
                         ) from None
    u = uniform(key, shape, device=device, minval=a, maxval=b)
    out = _f32(np.sqrt(2.0)) * erf_inv(u)
    lo = np.nextafter(np.float32(lower), np.float32(np.inf))
    hi = np.nextafter(np.float32(upper), np.float32(-np.inf))
    return torch.clamp(out, min=float(lo), max=float(hi))


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
