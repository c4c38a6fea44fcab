"""The port's ``se1d`` trunk (a stride-3 stem on the raw waveform, then
squeeze-excitation residual 1-D blocks with a projected shortcut where
the width changes, each ending in a 3x1 max pool) against the JAX
package's, on the CPU, at a tiny width: the checks of
``tests/torch_trunk_parity.py``."""

import pytest
import torch

from tests import torch_trunk_parity as tp

torch.set_num_threads(1)

CASE = tp.TrunkCase("se1d", dict(n_channels=4, n_layers=3,
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
