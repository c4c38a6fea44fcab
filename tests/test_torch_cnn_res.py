"""The port's ``res`` trunk (stride-2 residual blocks with projected
shortcuts) against the JAX package's, on the CPU, at a tiny width: the
checks of ``tests/torch_trunk_parity.py``, and the ``compute_dtype=
"bfloat16"`` forward of vgg and res (ROADMAP C6): convolutions and dense
layers in bfloat16 on both sides, BatchNorm statistics in float32; the
scores agree within the float32 gate (measured equal)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.models import short_cnn
from tests import torch_trunk_parity as tp

torch.set_num_threads(1)

CASE = tp.TrunkCase("res", dict(n_channels=4, n_mels=16, n_layers=3,
                                input_length=4096))


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


def test_stride_two_blocks_ceil_halve_odd_sizes():
    """Odd mel and frame counts (15 x 17): the port's blocks give the
    shapes Flax's padding-1 stride-2 convolutions give (ceil(n / 2))."""
    cfg = dataclasses.replace(CASE.cfg, n_mels=15)
    assert cfg.n_frames % 2 == 1
    t = short_cnn._Trunk(short_cnn.init_variables(
        convert.prng.key(0, "cpu"), cfg, "cpu"), False, torch.float32)
    out = short_cnn._res_blocks(
        t, torch.zeros(2, 1, cfg.n_mels, cfg.n_frames), cfg)
    s = jax.ShapeDtypeStruct((2, cfg.n_mels, cfg.n_frames, 1), np.float32)
    for width in cfg.channel_widths:
        s = jax.eval_shape(lambda x, w=width: jax_cnn.ResBlock(
            w).init_with_output(jax.random.key(0), x, False)[0], s)
    assert tuple(out.shape) == (2, s.shape[3], s.shape[1], s.shape[2])
    assert out.shape[2:] == (2, 3)


@pytest.mark.parametrize("arch", ["vgg", "res"])
def test_bfloat16_forward_matches_jax(arch):
    case = tp.TrunkCase(arch, dict(n_channels=4, n_mels=16, n_layers=3,
                                   input_length=4096,
                                   compute_dtype="bfloat16"))
    jv = case.init(jax.random.key(2))
    pv = convert.cnn_variables_from_jax(jv, case.cfg, "cpu")
    x = case.x(6, 3)
    ref = np.asarray(jax.jit(lambda v, x: jax_cnn.apply_infer(
        v, x, case.jcfg))(jv, x))
    got = short_cnn.apply_infer(pv, torch.from_numpy(x), case.cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **tp.SCORE_TOL)
