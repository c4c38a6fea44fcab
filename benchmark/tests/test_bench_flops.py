"""``benchmark.flops`` on a tiny trunk, against a count by hand."""

import pytest

from benchmark import flops
from benchmark.reference.trunk import TrunkConfig

TINY = TrunkConfig(arch="vgg", n_channels=2, n_mels=4, n_fft=8,
                   hop_length=4, n_layers=2, input_length=28, n_class=3,
                   sample_rate=400, f_max=200.0)


def test_forward_by_hand():
    # 28 samples, hop 4: 8 frames; 5 frequency bins
    t, nf = 8, 5
    frontend = 2 * t * 8 * nf * 2 + 2 * 4 * nf * t
    # conv 1 -> 2 on 4 x 8, pool; conv 2 -> 2 on 2 x 4 (both layers take
    # n_channels: only from the third on do the widths double)
    convs = (2 * 9 * 1 + 6) * 2 * 32 + (2 * 9 * 2 + 6) * 2 * 8
    dense = 2 * 2 * 2 + 2 * 2 * 3
    assert flops.forward_flops(TINY) == (frontend, convs + dense)


def test_training_adds_twice_the_trunk():
    fwd = flops.crop_work(TINY, 5, False)
    train = flops.crop_work(TINY, 5, True)
    frontend, trunk = flops.forward_flops(TINY)
    assert fwd.flops == frontend + trunk
    assert train.flops == frontend + 3 * trunk
    assert train.conv_flops == 3 * fwd.conv_flops == 3 * (
        2 * 9 * 1 * 2 * 32 + 2 * 9 * 2 * 2 * 8)


def test_conv_bound_is_the_larger_of_operations_and_bytes():
    w = flops.crop_work(TINY, 1, False)
    f1, f2 = 2 * 9 * 1 * 2 * 32, 2 * 9 * 2 * 2 * 8
    b1 = 4 * (32 + 2 * 32) + 4 * 9 * 2
    b2 = 4 * (2 * 8 + 2 * 8) + 4 * 9 * 4
    assert w.conv_bound_s == pytest.approx(
        max(f1 / flops.PEAK_FLOPS, b1 / flops.PEAK_BYTES)
        + max(f2 / flops.PEAK_FLOPS, b2 / flops.PEAK_BYTES))


def test_published_vgg_crop():
    # 4.19 GFLOP a crop forward at the published widths
    assert sum(flops.forward_flops(TrunkConfig())) == pytest.approx(
        4.1917e9, rel=1e-4)


def test_iteration_counts_real_crops_only():
    it = flops.iteration_work(TINY, members=2, n_live=7, n_train_q=3,
                              n_test=4, retrain_epochs=2)
    one = flops.crop_work(TINY, 256, False).flops
    train = flops.crop_work(TINY, 5, True).flops
    val = flops.crop_work(TINY, 4, False).flops
    assert it.flops == pytest.approx(2 * 7 * one + 2 * 2 * 3 * train
                                     + 2 * 3 * 4 * val)
