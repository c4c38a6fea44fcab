"""The port's ``musicnn`` trunk (vertical convolutions over 40% and 70% of
the mel axis, horizontal 1-D convolutions of 32 and 64 frames with
Flax's asymmetric padding, concatenated, then a temporal mid-end)
against the JAX package's, on the CPU, at a tiny width: the checks of
``tests/torch_trunk_parity.py``.

The train-mode scores are held within atol 5e-5, not 1e-5: a train-mode
BatchNorm over 4 crops x 17 frames divides by small batch variances, and
at seed 4 JAX's float32 forward sits 1.4e-5 from a float64 forward of
the port, the port's float32 4.3e-6 (inference stays within 1e-5)."""

import pytest
import torch

from tests import torch_trunk_parity as tp

torch.set_num_threads(1)

CASE = tp.TrunkCase("musicnn", dict(n_channels=4, n_mels=16, n_layers=3,
                                    input_length=4096),
                    train_tol={"rtol": 0, "atol": 5e-5})


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
