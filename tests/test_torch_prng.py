"""The port's threefry PRNG against ``jax.random`` on the CPU, bit for bit,
under ``jax_threefry_partitionable=True`` (set in ``tests/conftest.py``)."""

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu_torch import convert, prng

torch.set_num_threads(1)

SEEDS = [0, 1, 1987, -1, 2**31 - 1, 2**40 + 3]
SHAPES = [(), (1,), (7,), (1000,), (3, 5)]


def _keys(seed):
    return jax.random.key(seed), prng.key(seed, "cpu")


def _assert_bits_equal(port, ref):
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == np.float32:      # compare the bits, not the values
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    jk, tk = _keys(seed)
    assert tk.dtype == torch.uint32 and tk.shape == (2,)
    _assert_bits_equal(prng.key_data(tk), jax.random.key_data(jk))


@pytest.mark.parametrize("num", [2, 5, (2, 3)])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    jk, tk = _keys(seed)
    _assert_bits_equal(prng.split(tk, num),
                       jax.random.key_data(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_chains_match_jax(seed):
    jk, tk = _keys(seed)
    for data in (0, 7, 2**31 + 5):
        _assert_bits_equal(prng.fold_in(tk, data),
                           jax.random.key_data(jax.random.fold_in(jk, data)))
    # the acquirer's stream: split, keep the first, draw with the second
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        _assert_bits_equal(prng.uniform(tsub, (9,)),
                           jax.random.uniform(jsub, (9,)))
    _assert_bits_equal(tk, jax.random.key_data(jk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_bits_match_jax(seed, shape):
    jk, tk = _keys(seed)
    u = prng.uniform(tk, shape)
    _assert_bits_equal(u, jax.random.uniform(jk, shape))
    assert bool(((u >= 0) & (u < 1)).all())
    _assert_bits_equal(prng.random_bits(tk, shape), jax.random.bits(jk, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_matches_jax(seed):
    jk, tk = _keys(seed)
    _assert_bits_equal(prng.bernoulli(tk, 0.3, (50,)),
                       jax.random.bernoulli(jk, 0.3, (50,)))
    p = np.linspace(0, 1, 20, dtype=np.float32)
    _assert_bits_equal(prng.bernoulli(tk, torch.from_numpy(p)),
                       jax.random.bernoulli(jk, p))


def test_key_data_round_trips_and_crosses_from_jax():
    jk = jax.random.fold_in(jax.random.key(1987), 11)
    data = np.asarray(jax.random.key_data(jk))
    assert data.max() > 2**31          # a word with the top bit set
    tk = convert.key_from_jax(data.tolist(), device="cpu")
    _assert_bits_equal(tk, data)
    _assert_bits_equal(prng.wrap_key_data(prng.key_data(tk)), data)
    _assert_bits_equal(prng.uniform(tk, (100,)), jax.random.uniform(jk, (100,)))
    with pytest.raises(ValueError):
        convert.key_from_jax([1, 2, 3], device="cpu")
    with pytest.raises(TypeError):
        prng.split(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        prng.uniform(tk, (3,), dtype=torch.float64)


def test_draws_follow_the_key_or_the_given_device():
    tk = prng.key(5, "cpu")
    assert prng.uniform(tk, (4,)).device == torch.device("cpu")
    assert prng.uniform(tk, (4,), device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prng.key(5)
