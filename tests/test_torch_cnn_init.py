"""ROADMAP C12: a fresh CNN member of the port is the JAX package's.

``short_cnn.init_variables(prng.key(s))`` against the JAX
``init_variables(jax.random.key(s))`` (Flax's ``init`` over threefry) for
all five trunk families at tiny widths: every bias, BatchNorm variable and
``bw_q`` equal; every kernel entry within two float32 ulps of the
truncated normal before scaling, and the share of entries that differ at
all is asserted to be 0 (measured: the kernels are bit-equal).  Each
kernel is drawn under Flax's per-module key (``prng.fold_in_static(key,
*module_path, 1)``) by ``prng.truncated_normal``, which reproduces
``jax.random.truncated_normal`` bit for bit on the CPU: the uniform's
multiply-add and XLA's ``erf_inv``, ``log1p`` and ``log`` polynomials
with their multiply-adds contracted, emulated in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.models import short_cnn

torch.set_num_threads(1)

ARCHS = {
    "vgg": dict(n_channels=4, n_mels=16, n_layers=3, input_length=4096),
    "res": dict(n_channels=4, n_mels=16, n_layers=3, input_length=4096),
    "harm": dict(n_channels=4, n_layers=3, input_length=4096, n_harmonic=2,
                 semitone_scale=1, bw_q_init=0.8),
    "se1d": dict(n_channels=4, n_layers=3, input_length=4096),
    "musicnn": dict(n_channels=4, n_mels=16, n_layers=3, input_length=4096),
}
#: entries of a kernel allowed to differ from Flax's (none, measured)
DIFFERING_SHARE = 0.0
ULPS = 2


def _jax_init(arch):
    cfg = JaxCNNConfig(arch=arch, **ARCHS[arch])
    return jax.jit(lambda k: jax_cnn.init_variables(k, cfg))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_variables_are_flaxs(arch):
    cfg = CNNConfig(arch=arch, **ARCHS[arch])
    init = _jax_init(arch)
    for seed in (0, 1987):
        ref = convert.cnn_variables_from_jax(init(jax.random.key(seed)), cfg,
                                             "cpu")
        got = short_cnn.init_variables(prng.key(seed, "cpu"), cfg, "cpu")
        assert list(got) == list(short_cnn.variable_shapes(cfg)) == list(ref)
        n_diff = n_all = 0
        for k, t in got.items():
            r = ref[k].numpy()
            if k.endswith(".weight") and t.ndim > 1:
                fan_in = int(np.prod(t.shape[1:]))
                stddev = np.sqrt(np.float32(1 / fan_in)) / np.float32(
                    .87962566103423978)
                z = np.abs(r.astype(np.float64) / stddev).astype(np.float32)
                tol = ULPS * np.spacing(z).astype(np.float64) * stddev
                assert np.all(np.abs(t.numpy() - r) <= tol), k
                assert np.all(np.abs(r) < 2 * stddev) and r.std() > 0, k
                n_diff += int((t.numpy() != r).sum())
                n_all += r.size
            else:
                assert torch.equal(t, ref[k]), k
        assert n_diff / n_all <= DIFFERING_SHARE
    if arch == "harm":
        assert got["bw_q"].tolist() == [np.float32(0.8)]


def test_erf_of_the_bounds_is_xlas():
    sqrt2 = np.float32(np.sqrt(2))
    for bound, bits in ((2.0, 0x3F745A18), (-2.0, 0xBF745A18)):
        ours = np.float32(prng.ERF_OF_BOUND[bound])
        assert ours.view(np.uint32) == bits
        assert ours == np.asarray(jax.scipy.special.erf(
            np.float32(bound) / sqrt2))


@pytest.mark.parametrize("seed, shape", [
    (3, (200_000,)), (0, (3, 3, 1, 7)), (11, (257, 129)), (5, (16, 4))])
def test_truncated_normal_is_jaxs(seed, shape):
    got = prng.truncated_normal(prng.key(seed, "cpu"), -2, 2, shape)
    ref = np.asarray(jax.random.truncated_normal(jax.random.key(seed), -2.0,
                                                 2.0, shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="bounds"):
        prng.truncated_normal(prng.key(seed, "cpu"), -3, 3, shape)


@pytest.mark.parametrize("lo, hi", [(-0.3, 2.5), (-0.9544997, 0.9544997),
                                    (0.0, 1.0), (5.0, 5.5)])
def test_uniform_on_a_range_is_jaxs(lo, hi):
    for seed in (0, 9):
        got = prng.uniform(prng.key(seed, "cpu"), (50_000,), minval=lo,
                           maxval=hi)
        ref = np.asarray(jax.random.uniform(jax.random.key(seed), (50_000,),
                                            minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_erf_inv_is_xlas():
    """Bit-equal over truncated_normal's range (``|x| <= erf(sqrt 2)``);
    within one ulp on the rest of (-1, 1), where 32 of 2,000,001 grid
    points differ (the emulated multiply-adds round otherwise there);
    +-inf at +-1."""
    x = np.linspace(-0.99999, 0.99999, 400_001).astype(np.float32)
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    inside = np.abs(x) <= prng.ERF_OF_BOUND[2.0]
    np.testing.assert_array_equal(got[inside], ref[inside])
    assert np.all(np.abs(got - ref) <= np.spacing(np.abs(ref)))
    edges = np.array([-1.0, 1.0, 0.0, 1e-30], np.float32)
    np.testing.assert_array_equal(
        prng.erf_inv(torch.from_numpy(edges)).numpy(),
        np.asarray(jax.scipy.special.erfinv(jnp.asarray(edges))))
    # torch's own erfinv is not XLA's
    assert (torch.erfinv(torch.from_numpy(x)).numpy() != got).mean() > 0.1
