"""The port's ``harm`` trunk (the vgg blocks over the learnable harmonic
frontend) against the JAX package's, on the CPU, at a tiny width: the
checks of ``tests/torch_trunk_parity.py``, ``fit_many`` through the adam
-> sgd transition with ``bw_q`` trained and reloaded, the note grid, the
filterbank and ``bw_q``'s gradient.

The note grid and the filterbank equal the JAX functions' bit for bit
(the filterbank against JAX's op-by-op dispatch; inside a jitted program
XLA fuses its multiply-adds and moves entries by up to 3e-6, so the dB
image of a crop is held within 1e-3 dB).  ``bw_q``'s gradient through a
member's mean score agrees within rtol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.ops import harmonic as jax_harmonic
from consensus_entropy_tpu_torch.ops import harmonic
from consensus_entropy_tpu_torch.models import short_cnn
from tests import torch_trunk_parity as tp

torch.set_num_threads(1)

CASE = tp.TrunkCase("harm", dict(n_channels=4, n_layers=3,
                                 input_length=4096, n_harmonic=2,
                                 semitone_scale=1), fit_epochs=2)


@pytest.fixture(scope="module")
def nets():
    return CASE.nets()


@pytest.mark.parametrize("member", [0, 1])
def test_inference_and_features_match_jax(nets, member):
    CASE.check_inference(nets, member)


@pytest.mark.parametrize("seed", [3, 4])
def test_train_forward_dropout_and_bn_update_match_jax(nets, seed):
    CASE.check_train(nets, seed)


def test_qbdc_infer_matches_jax(nets):
    CASE.check_qbdc(nets)


def test_committee_crops_and_scores_match_jax(nets):
    CASE.check_committee(nets)


def test_fit_many_matches_jax(nets):
    CASE.check_fit_many(nets)


def test_member_files_keep_the_trunk_family(nets, tmp_path):
    CASE.check_member_files(nets, tmp_path)


@pytest.mark.parametrize("sr, n_harmonic, scale", [
    (16000, 6, 2), (16000, 2, 1), (22050, 4, 3)])
def test_note_grid_and_filterbank_match_jax(sr, n_harmonic, scale):
    centers, level = harmonic.harmonic_center_freqs(sr, n_harmonic, scale)
    ref_c, ref_level = jax_harmonic.harmonic_center_freqs(sr, n_harmonic,
                                                          scale)
    assert level == ref_level and centers.dtype == np.float32
    np.testing.assert_array_equal(centers, ref_c)
    for q in (1.0, 0.7, 2.5):
        bw_q = np.array([q], np.float32)
        got = harmonic.harmonic_filterbank(
            torch.from_numpy(bw_q), sample_rate=sr, n_harmonic=n_harmonic,
            semitone_scale=scale).numpy()
        ref = np.asarray(jax_harmonic.harmonic_filterbank(
            jnp.asarray(bw_q), sample_rate=sr, n_harmonic=n_harmonic,
            semitone_scale=scale))
        assert got.shape == (257, n_harmonic * level)
        np.testing.assert_array_equal(got, ref)


def test_default_level_and_spectrogram_match_jax():
    """At the default geometry the note grid is 128 levels (as n_mels);
    the dB image of a crop agrees within 1e-3 dB."""
    assert CASE.cfg.harm_level == 83 and CASE.jcfg.harm_level == 83
    from consensus_entropy_tpu_torch.config import CNNConfig

    assert CNNConfig(arch="harm").harm_level == 128
    x = CASE.x(2, 4)
    got = harmonic.harmonic_spectrogram(torch.from_numpy(x), torch.ones(1),
                                        n_harmonic=2, semitone_scale=1)
    ref = jax.jit(lambda x: jax_harmonic.harmonic_spectrogram(
        x, jnp.ones(1), n_harmonic=2, semitone_scale=1))(x)
    assert tuple(got.shape) == (2, 2, 83, CASE.cfg.n_frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def test_bw_q_gradient_matches_jax(nets):
    jv, pv = nets
    x = CASE.x(3, 6)

    def jax_loss(bw_q):
        params = dict(jv[1]["params"], bw_q=bw_q)
        return CASE.infer({"params": params,
                           "batch_stats": jv[1]["batch_stats"]}, x).mean()

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(
        jv[1]["params"]["bw_q"])))
    bw_q = pv[1]["bw_q"].clone().requires_grad_(True)
    short_cnn.apply_infer({**pv[1], "bw_q": bw_q}, torch.from_numpy(x),
                          CASE.cfg).mean().backward()
    assert bw_q.grad.shape == (1,) and float(bw_q.grad.abs()) > 0
    np.testing.assert_allclose(bw_q.grad.numpy(), ref, rtol=1e-3)
