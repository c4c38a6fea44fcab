"""The port's sequence-parallel full-song scoring against the JAX
package's, on the CPU.

``plan_windows`` gives the JAX plan's fields over a grid of song lengths,
shard counts and hops, and refuses what it refuses.  ``make_full_song_
scorer`` over a ``seq`` mesh of 1, 2 and 4 CPU entries (the halo copied
from the right neighbour's shard) agrees with JAX's ``full_song_probs_
reference`` on the same (converted) members within the CNN gate (rtol
1e-4, atol 1e-5), with the port's own one-device reference, and with the
port's window-grid ``predict_songs_cnn`` of the same song.
``Committee.predict_song_sequence`` caches its scorers by geometry and
mesh and refuses a committee without CNN members."""

import re

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.config import CNNConfig as JaxCNNConfig
from consensus_entropy_tpu.models import short_cnn as jax_cnn
from consensus_entropy_tpu.parallel import sequence as jax_sequence
from consensus_entropy_tpu_torch import convert
from consensus_entropy_tpu_torch.config import CNNConfig
from consensus_entropy_tpu_torch.data.audio import DeviceWaveformStore
from consensus_entropy_tpu_torch.models.committee import CNNMember, Committee
from consensus_entropy_tpu_torch.parallel import sequence
from consensus_entropy_tpu_torch.parallel.mesh import make_seq_mesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TINY_KW = dict(n_channels=4, n_fft=64, hop_length=32, n_mels=16,
               n_layers=2, input_length=1024)
TINY, JTINY = CNNConfig(**TINY_KW), JaxCNNConfig(**TINY_KW)


@pytest.fixture(scope="module")
def members():
    """Two members made by JAX, and the port's conversion of them."""
    init = jax.jit(lambda k: jax_cnn.init_variables(k, JTINY))
    jv = [init(jax.random.key(i)) for i in range(2)]
    return jv, [convert.cnn_variables_from_jax(v, TINY, "cpu") for v in jv]


def _song(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.05).astype(np.float32)


@pytest.mark.parametrize("n_samples", [100, 1024, 5_000, 10_000, 16_384,
                                       50_000])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("hop", [None, 1024, 512, 300, 256])
def test_plan_windows_is_jax(n_samples, n_shards, hop):
    kw = dict(window=1024, hop=hop)
    try:
        want = jax_sequence.plan_windows(n_samples, n_shards, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            sequence.plan_windows(n_samples, n_shards, **kw)
        return
    got = sequence.plan_windows(n_samples, n_shards, **kw)
    assert tuple(got) == tuple(want) and got.n_shards == want.n_shards
    np.testing.assert_array_equal(
        sequence.pad_song(_song(n_samples), got),
        jax_sequence.pad_song(_song(n_samples), want))


def test_plan_windows_rejections():
    for mod in (sequence, jax_sequence):
        with pytest.raises(ValueError, match="hop"):
            mod.plan_windows(5000, 4, window=1024, hop=2048)
        with pytest.raises(ValueError, match="overlap"):
            mod.plan_windows(2816, 8, window=1024, hop=256)
        with pytest.raises(ValueError, match="expected"):
            mod.pad_song(np.zeros((2, 3)),
                         mod.plan_windows(5000, 2, window=1024))


@pytest.mark.parametrize("n_samples,hop", [
    (16 * 1024, 1024),      # exact tiling, no halo
    (10_000, 1024),         # ragged tail, no halo
    (10_000, 512),          # 50% overlap: the halo copy
    (7_000, 300),           # a hop that does not divide, halo
    (500, 1024),            # shorter than one window
])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_scorer_matches_the_jax_reference(members, n_samples, hop, n_dev):
    jv, tv = members
    wave = _song(n_samples, 3)
    mesh = make_seq_mesh(["cpu"] * n_dev)
    plan = sequence.plan_windows(n_samples, n_dev, window=1024, hop=hop)
    got = sequence.make_full_song_scorer(mesh, plan, TINY)(
        tv, torch.from_numpy(sequence.pad_song(wave, plan)))
    assert got.shape == (2, 4)
    jplan = jax_sequence.plan_windows(n_samples, 8, window=1024, hop=hop)
    want = jax_sequence.full_song_probs_reference(
        jax_cnn.stack_params(jv), wave, jplan, JTINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ours = sequence.full_song_probs_reference(tv, wave, plan, TINY)
    np.testing.assert_allclose(got.numpy(), ours.numpy(), **TOL)


def test_scorer_validates_mesh_and_window(members):
    mesh = make_seq_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="shards"):
        sequence.make_full_song_scorer(
            mesh, sequence.plan_windows(8192, 2, window=1024), TINY)
    with pytest.raises(ValueError, match="input_length"):
        sequence.make_full_song_scorer(
            mesh, sequence.plan_windows(8192, 4, window=512), TINY)


def test_committee_predict_song_sequence(members):
    """The committee's long-audio path equals its window-grid scores of
    the same song (``predict_songs_cnn`` with ``full_song_hop``) within
    the gate, and reuses one scorer per geometry and mesh value."""
    _, tv = members
    com = Committee([], [CNNMember(f"c{i}", v, TINY)
                         for i, v in enumerate(tv)], TINY,
                    full_song_hop=512, device="cpu")
    wave = _song(20_000, 5)
    got = com.predict_song_sequence(wave, make_seq_mesh(["cpu"] * 4))
    assert got.shape == (2, 4)
    store = DeviceWaveformStore({"s": wave}, 1024, "cpu")
    grid = com.predict_songs_cnn(store, ["s"], None)[:, 0]
    np.testing.assert_allclose(got.numpy(), grid.numpy(), **TOL)
    assert len(com._seq_scorers) == 1
    # another length in the same geometry and an equal, rebuilt mesh hit
    com.predict_song_sequence(_song(19_800, 6), make_seq_mesh(["cpu"] * 4))
    assert len(com._seq_scorers) == 1
    com.predict_song_sequence(_song(40_000, 7), make_seq_mesh(["cpu"] * 4))
    assert len(com._seq_scorers) == 2
    # an explicit hop overrides full_song_hop
    flat = com.predict_song_sequence(wave, make_seq_mesh(["cpu"] * 2),
                                     hop=1024)
    plan = sequence.plan_windows(len(wave), 2, window=1024, hop=1024)
    np.testing.assert_allclose(
        flat.numpy(),
        sequence.full_song_probs_reference(tv, wave, plan, TINY).numpy(),
        **TOL)


def test_committee_predict_song_sequence_needs_cnn():
    com = Committee([], [], TINY)
    with pytest.raises(ValueError, match="no CNN members"):
        com.predict_song_sequence(_song(10_000), make_seq_mesh(["cpu"]))
