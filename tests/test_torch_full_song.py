"""Full-song (window-grid) scoring of the port against the JAX package's,
on the CPU, at ``tests/test_full_song.py``'s tiny geometry.

The stride grid of ``DeviceWaveformStore.window_batch`` and the host
store's crops and windows equal JAX's bit for bit (the host store's crop
start is JAX's numpy ``floor(float32 u * (len - L))``).
``Committee.predict_songs_cnn`` with ``full_song_hop`` (chunks of 8 songs,
the last padded by repeating its last song; the masked mean over valid
windows; ``pad_to`` repeating the last column) agrees with JAX's within
``tests/test_full_song.py``'s tolerance, rtol 2e-4 / atol 2e-6, for vgg
and harm members, a song with one valid window among them."""

import os

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.data.audio import DeviceWaveformStore as JaxStore
from consensus_entropy_tpu.data.audio import HostWaveformStore as JaxHost
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.models.committee import CNNMember as JaxMember
from consensus_entropy_tpu.models.committee import Committee as JaxCommittee
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.data import audio
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee

torch.set_num_threads(1)

TINY_KW = dict(n_channels=4, n_fft=64, hop_length=32, n_mels=16,
               n_layers=2, input_length=1024)
TOL = {"rtol": 2e-4, "atol": 2e-6}


@pytest.fixture(scope="module")
def waves():
    """11 songs (two window chunks): s00 exactly one window long."""
    rng = np.random.default_rng(5)
    return {f"s{i:02d}": (rng.standard_normal(1024 + 350 * i) * 0.05
                          ).astype(np.float32) for i in range(11)}


@pytest.fixture(scope="module")
def npy_dir(waves, tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    for sid, w in waves.items():
        np.save(os.path.join(d, f"{sid}.npy"), w)
    return str(d)


@pytest.mark.parametrize("hop", [300, 512, 1024])
def test_window_batch_matches_jax(waves, hop):
    jstore = JaxStore(waves, 1024)
    store = audio.DeviceWaveformStore(waves, 1024, "cpu")
    songs = ["s00", "s03", "s10", "s07"]
    assert store.n_windows(hop) == jstore.n_windows(hop)
    windows, valid = store.window_batch(store.row_of(songs), hop)
    jw, jv = jstore.window_batch(jstore.row_of(songs), hop)
    assert windows.shape == (4, store.n_windows(hop), 1024)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jw))
    assert valid[:, 0].all() and valid[0].sum() == 1  # s00: one window


def test_host_store_matches_jax_host_store(waves, npy_dir):
    songs = list(waves)
    host = audio.HostWaveformStore(npy_dir, songs, 1024, device="cpu")
    jhost = JaxHost(npy_dir, songs, 1024)
    rows = host.row_of(["s09", "s01", "s04"])
    for seed in (0, 3):
        np.testing.assert_array_equal(
            host.sample_crops(prng.key(seed, "cpu"), rows).numpy(),
            np.asarray(jhost.sample_crops(jax.random.key(seed), rows)))
    w, v = host.window_batch(rows, 400)
    jw, jv = jhost.window_batch(rows, 400)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # the device store's windows where valid
    dw, dv = audio.DeviceWaveformStore(waves, 1024, "cpu").window_batch(
        rows, 400)
    assert torch.equal(dv, v) and torch.equal(dw[dv], w[v])
    with pytest.raises(ValueError, match="shorter"):
        audio.HostWaveformStore(npy_dir, songs, 1100, device="cpu")


def _committees(arch, hop, n_members=2):
    cfg = CNNConfig(arch=arch, **TINY_KW)
    jcfg = JaxCNNConfig(arch=arch, **TINY_KW)
    init = jax.jit(lambda k: jax_cnn.init_variables(k, jcfg))
    jv = [init(jax.random.key(i)) for i in range(n_members)]
    jcom = JaxCommittee([], [JaxMember(f"c{i}", v, jcfg)
                             for i, v in enumerate(jv)], jcfg,
                        full_song_hop=hop)
    com = Committee([], [CNNMember(f"c{i}", convert.cnn_variables_from_jax(
        v, cfg, "cpu"), cfg) for i, v in enumerate(jv)], cfg,
        full_song_hop=hop, device="cpu")
    return jcom, com


@pytest.mark.parametrize("arch", ["vgg", "harm"])
def test_full_song_scores_match_jax(waves, npy_dir, arch):
    jcom, com = _committees(arch, 512)
    jstore = JaxStore(waves, 1024)
    store = audio.DeviceWaveformStore(waves, 1024, "cpu")
    host = audio.HostWaveformStore(npy_dir, list(waves), 1024, device="cpu")
    for songs, pad_to in ((list(waves), None), (list(waves)[2:7], 12),
                          (["s00"], None)):
        ref = np.asarray(jcom.predict_songs_cnn(jstore, songs, None,
                                                pad_to=pad_to))
        got = com.predict_songs_cnn(store, songs, None, pad_to=pad_to)
        assert got.shape == (2, pad_to or len(songs), 4)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        # the host store assembles the same windows
        assert torch.equal(com.predict_songs_cnn(host, songs, None,
                                                 pad_to=pad_to), got)
    # no crop randomness: the pass's key changes nothing
    a = com.pool_probs(None, list(waves), store=store, key=prng.key(
        1, "cpu"))
    b = com.pool_probs(None, list(waves), store=store, key=prng.key(
        2, "cpu"))
    assert torch.equal(a, b)


def test_hop_validation_and_empty_song_list(waves):
    cfg, jcfg = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)
    v = jax.jit(lambda k: jax_cnn.init_variables(k, jcfg))(
        jax.random.key(0))
    member = CNNMember("c0", convert.cnn_variables_from_jax(v, cfg, "cpu"),
                       cfg)
    for hop in (0, 1025):
        with pytest.raises(ValueError) as ours:
            Committee([], [member], cfg, full_song_hop=hop, device="cpu")
        with pytest.raises(ValueError) as theirs:
            JaxCommittee([], [JaxMember("c0", v, jcfg)], jcfg,
                         full_song_hop=hop)
        assert str(ours.value) == str(theirs.value)
    com = Committee([], [member], cfg, full_song_hop=1024, device="cpu")
    store = audio.DeviceWaveformStore(waves, 1024, "cpu")
    assert com.predict_songs_cnn(store, [], None).shape == (1, 0, 4)
    assert com.predict_songs_cnn(store, [], None, pad_to=3).shape == (1, 3, 4)
