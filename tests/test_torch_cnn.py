"""The port's vgg ShortChunkCNN and its committee path against the JAX
package's, on the CPU, at a tiny width (``tests/test_cnn.py``'s TINY).

JAX-initialized variables are carried across by
``convert.cnn_variables_from_jax`` (and through ``CETPU1`` files by
``convert.read_cetpu_checkpoint``); the same numpy waveforms and keys go
through both.  Draws are equal bit for bit: crops (with the 256-crop
bucket padding), qbdc's unit masks, the training forward's dropout mask
(Flax's ``Dropout_0`` key) and ``prng.permutation``.  Float outputs are
float32 convolutions summed in two orders: sigmoid scores within atol 1e-5,
features and BatchNorm statistics within rtol 1e-4 / atol 1e-4."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.config import TrainConfig as JaxTrainConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.models.committee import CNNMember as JaxMember
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu.models.committee import _cast_tree_bf16
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.config import CNNConfig, TrainConfig
from consensus_entropy_tpu_torch.data import audio
from consensus_entropy_tpu_torch.models import short_cnn
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee

torch.set_num_threads(1)

TINY_KW = dict(n_channels=4, n_mels=32, n_layers=5, input_length=8192)
TINY, JAX_TINY = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)
SCORE_TOL = {"rtol": 0, "atol": 1e-5}
FEAT_TOL = {"rtol": 1e-4, "atol": 1e-4}

# the JAX side compiled once (its eager dispatch is the slow part here)
_init = jax.jit(lambda k: jax_cnn.init_variables(k, JAX_TINY))
_infer = jax.jit(lambda v, x: jax_cnn.apply_infer(v, x, JAX_TINY))
_features = jax.jit(lambda v, x: jax_cnn.apply_features(v, x, JAX_TINY))
_train = jax.jit(lambda v, x, k: jax_cnn.apply_train(v, x, k, JAX_TINY))
_qbdc = jax.jit(lambda v, x, k: jax_cnn.qbdc_infer(v, x, k, JAX_TINY))


@pytest.fixture(scope="module")
def nets():
    """Two JAX-initialized members, the second with moved BN statistics,
    and the port's copies."""
    jv = [_init(jax.random.key(i)) for i in range(2)]
    rng = np.random.default_rng(0)
    jv[1] = {"params": jv[1]["params"], "batch_stats": jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(
            np.float32), jv[1]["batch_stats"])}
    return jv, [convert.cnn_variables_from_jax(v, TINY, "cpu") for v in jv]


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(7)
    return {f"s{i:02d}": rng.standard_normal(
        int(rng.integers(8200, 9400))).astype(np.float32) for i in range(12)}


def _x(n, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (n, TINY.input_length)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("member", [0, 1])
def test_inference_forward_matches_jax(nets, member):
    jv, pv = nets
    x = _x(5)
    np.testing.assert_allclose(
        short_cnn.apply_infer(pv[member], torch.from_numpy(x), TINY).numpy(),
        np.asarray(_infer(jv[member], x)),
        **SCORE_TOL)
    np.testing.assert_allclose(
        short_cnn.apply_features(pv[member], torch.from_numpy(x),
                                 TINY).numpy(),
        np.asarray(_features(jv[member], x)),
        **FEAT_TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_train_forward_dropout_and_bn_update_match_jax(nets, seed):
    jv, pv = nets
    x = _x(4, seed)
    out, stats = _train(jv[1], x, jax.random.key(seed))
    got, new = short_cnn.apply_train(pv[1], torch.from_numpy(x),
                                     prng.key(seed, "cpu"), TINY)
    # equal dropout masks: the zeros sit in the same places
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **SCORE_TOL)
    ref = convert.cnn_variables_from_jax(
        {"params": jv[1]["params"], "batch_stats": stats}, TINY, "cpu")
    assert set(new) == {k for k in ref if short_cnn.is_stat(k)}
    for k, t in new.items():
        np.testing.assert_allclose(t.numpy(), ref[k].numpy(), **FEAT_TOL,
                                   err_msg=k)
    # the update is Flax's: 0.9 old + 0.1 batch, biased variance
    assert not torch.allclose(new["spec_bn.running_var"],
                              pv[1]["spec_bn.running_var"])


def test_dropout_key_is_flaxs():
    x = np.ones((3, 16), np.float32)
    import flax.linen as nn

    class Drop(nn.Module):
        @nn.compact
        def __call__(self, v):
            return nn.Dropout(0.5, deterministic=False)(v)

    for seed in range(3):
        ref = np.asarray(Drop().apply({}, x, rngs={
            "dropout": jax.random.key(seed)})) != 0
        mask = prng.bernoulli(prng.fold_in_static(
            prng.key(seed, "cpu"), *short_cnn.DROPOUT_RNG_PATH), 0.5,
            (3, 16), device="cpu")
        np.testing.assert_array_equal(mask.numpy(), ref)


def test_qbdc_infer_matches_jax(nets):
    jv, pv = nets
    x = _x(6, 5)
    keys = jax.random.split(jax.random.key(9), 7)
    ref = np.asarray(_qbdc(jv[0], x, keys))
    got = short_cnn.qbdc_infer(pv[0], torch.from_numpy(x),
                               prng.split(prng.key(9, "cpu"), 7), TINY)
    assert got.shape == (7, 6, 4)
    np.testing.assert_allclose(got.numpy(), ref, **SCORE_TOL)
    assert (got[0] != got[1]).any()  # distinct subnetworks


@pytest.mark.parametrize("n, pad_to", [(5, None), (9, 300), (12, 12)])
def test_committee_crops_and_scores_match_jax(nets, waves, n, pad_to):
    jv, pv = nets
    songs = list(waves)[:n]
    jstore = JaxStore(waves, TINY.input_length)
    store = audio.DeviceWaveformStore(waves, TINY.input_length, "cpu")
    key = jax.random.key(11)
    pkey = prng.key(11, "cpu")
    rows = store.row_of(songs)
    np.testing.assert_array_equal(
        store.sample_crops(pkey, rows).numpy(),
        np.asarray(jstore.sample_crops(key, jstore.row_of(songs))))
    jcom = JaxCommittee([], [JaxMember(f"c{i}", v, JAX_TINY)
                             for i, v in enumerate(jv)], JAX_TINY)
    com = Committee([], [CNNMember(f"c{i}", v, TINY)
                         for i, v in enumerate(pv)], TINY, device="cpu")
    ref = np.asarray(jcom.predict_songs_cnn(jstore, songs, key,
                                            pad_to=pad_to))
    got = com.predict_songs_cnn(store, songs, pkey, pad_to=pad_to).numpy()
    assert got.shape == (2, pad_to or n, 4)
    np.testing.assert_allclose(got, ref, **SCORE_TOL)
    qref = np.asarray(jcom.qbdc_pool_probs(jstore, songs, key, k=5,
                                           pad_to=pad_to))
    qgot = com.qbdc_pool_probs(store, songs, pkey, k=5,
                               pad_to=pad_to).numpy()
    np.testing.assert_allclose(qgot, qref, **SCORE_TOL)
    # the committee's pool_probs puts the CNN block first
    assert com.member_names == ["c0", "c1"]


@pytest.mark.parametrize("n", [1, 2, 10, 1625, 1626, 4000])
def test_permutation_matches_jax(n):
    for seed in (0, 5):
        np.testing.assert_array_equal(
            prng.permutation(prng.key(seed, "cpu"), n).numpy(),
            np.asarray(jax.random.permutation(jax.random.key(seed), n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_converts(nets, tmp_path, dtype):
    jv, _ = nets
    path = str(tmp_path / "classifier_cnn.c0.msgpack")
    member = JaxMember("c0", jv[1], JAX_TINY)
    variables = (jax.device_get(_cast_tree_bf16(jv[1]))
                 if dtype == "bfloat16" else None)
    member.save(path, variables=variables)
    loaded = JaxMember.load(path, JAX_TINY)  # the JAX reader's values
    tree, meta = convert.read_cetpu_checkpoint(path)
    assert meta["name"] == "c0" and meta["kind"] == "cnn_jax"
    ours = convert.cnn_member_from_jax(path, TINY)
    ref = convert.cnn_variables_from_jax(loaded.variables, TINY, "cpu")
    for k, t in ours.variables.items():
        assert torch.equal(t, ref[k]), k
    x = _x(3, 8)
    np.testing.assert_allclose(
        short_cnn.apply_infer(ours.variables, torch.from_numpy(x),
                              TINY).numpy(),
        np.asarray(_infer(loaded.variables, x)),
        **SCORE_TOL)
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        convert.read_cetpu_checkpoint(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_member_file_round_trip(nets, tmp_path, dtype):
    _, pv = nets
    m = CNNMember("cnn.it_0", pv[1], TINY)
    path = str(tmp_path / Committee.member_file(m))
    assert path.endswith("classifier_cnn.cnn.it_0.npz")
    m.save(path, dtype=dtype)
    back = CNNMember.load(path, dataclasses.replace(TINY, n_mels=32),
                          device="cpu")
    assert not back.ckpt_dirty and back.ckpt_clean_path == path
    for k, t in pv[1].items():
        want = t if dtype == "float32" else t.to(torch.bfloat16).float()
        assert torch.equal(back.variables[k], want), k
    # the file's frontend fields win over the caller's config
    wide = CNNConfig(n_channels=4, n_layers=5, input_length=8192,
                     n_mels=64)
    assert CNNMember.load(path, wide, device="cpu").config.n_mels == 32


def test_module_and_init(nets):
    """``init_variables``' names and shapes; an eval-mode ``apply`` is
    ``apply_infer`` and leaves the statistics alone, a train-mode one
    returns every BatchNorm's moved statistics; the init's ranges."""
    v = short_cnn.init_variables(prng.key(3, "cpu"), TINY, "cpu")
    shapes = short_cnn.variable_shapes(TINY)
    assert {k: tuple(t.shape) for k, t in v.items()} == shapes
    x = torch.from_numpy(_x(2, 9))
    with torch.no_grad():
        out, stats = short_cnn.apply(v, x, TINY)
        assert stats == {}
        np.testing.assert_array_equal(
            out.numpy(), short_cnn.apply_infer(v, x, TINY).numpy())
        _, stats = short_cnn.apply(v, x, TINY, train=True,
                                   dropout_key=prng.key(0, "cpu"))
    assert sorted(stats) == sorted(k for k in shapes if short_cnn.is_stat(k))
    assert not torch.equal(v["spec_bn.running_mean"],
                           stats["spec_bn.running_mean"])
    for k, t in short_cnn.init_variables(prng.key(0, "cpu"), TINY,
                                         "cpu").items():
        if k.endswith(("running_var", "bn.weight")):
            assert torch.all(t == 1), k
        elif k.endswith("weight"):
            bound = 2 * (1.0 / np.prod(t.shape[1:])) ** 0.5 / .8796
            assert t.std() > 0 and t.abs().max() <= bound + 1e-6, k


def test_config_and_store_checks(waves):
    assert [f.name for f in dataclasses.fields(CNNConfig)] == [
        f.name for f in dataclasses.fields(JaxCNNConfig)]
    assert dataclasses.asdict(CNNConfig()) == dataclasses.asdict(
        JaxCNNConfig())
    tc = {k: v for k, v in dataclasses.asdict(JaxTrainConfig()).items()
          if k != "scan_mesh_phases"}
    assert dataclasses.asdict(TrainConfig()) == tc
    assert CNNConfig().channel_widths == (128, 128, 256, 256, 256, 256, 512)
    # every trunk family is a config; each has the JAX geometry check
    assert CNNConfig(arch="res", n_mels=32).arch == "res"
    for arch, kw in (("vgg", {"n_mels": 32}), ("harm", {"n_harmonic": 12}),
                     ("se1d", {"input_length": 2000}),
                     ("musicnn", {"input_length": 2000})):
        with pytest.raises(ValueError, match="collapses") as ours:
            CNNConfig(arch=arch, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxCNNConfig(arch=arch, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="shorter"):
        audio.DeviceWaveformStore({"a": np.zeros(100, np.float32)}, 8192,
                                  "cpu")
    store = audio.DeviceWaveformStore(waves, 8192, "cpu")
    assert store.row_of(["s03", "s00"]).tolist() == [3, 0]
    windows, valid = store.window_batch([0], 4096)
    assert windows.shape == (1, store.n_windows(4096), 8192) and valid[0, 0]
    with pytest.raises(FileNotFoundError):
        audio.HostWaveformStore("npy", ["s00"], 8192, device="cpu")


def test_store_from_npy(waves, tmp_path):
    for sid, w in waves.items():
        np.save(os.path.join(tmp_path, f"{sid}.npy"), w)
    store = audio.device_store_from_npy(str(tmp_path), list(waves), 8192,
                                        "cpu")
    key = prng.key(2, "cpu")
    ref = audio.DeviceWaveformStore(waves, 8192, "cpu")
    assert torch.equal(store.sample_crops(key, [0, 5, 11]),
                       ref.sample_crops(key, [0, 5, 11]))
