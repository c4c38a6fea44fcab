"""The port's ``Acquirer`` against ``consensus_entropy_tpu.al.acquisition.
Acquirer`` on the CPU: in every mode, fused and unfused, the same probs
sequence gives the same song ids in each of 10 iterations, entropies within
the repo's gate, the same masks and the same host->device accounting;
replay, the device twins, staging and the degenerate-row sanitizer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.acquire.base import (
    sanitize_member_rows as jax_sanitize,
)
from consensus_entropy_tpu.al.acquisition import Acquirer as JaxAcquirer
from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.acquire.base import sanitize_member_rows
from consensus_entropy_tpu_torch.al.acquisition import Acquirer

torch.set_num_threads(1)

MODES = ["mc", "hc", "mix", "rand", "qbdc", "wmc"]
ITERS, Q, M = 10, 10, 4
# The repo's entropy gate (tests/test_pallas_scoring.py).
RTOL, ATOL = 1e-5, 1e-6


def _hc(rng, n):
    counts = rng.integers(0, 20, size=(n, 4)).astype(np.float64)
    counts[:, 0] += 1
    return np.round(counts / counts.sum(1, keepdims=True), 3).astype(
        np.float32)


def _pair(songs, hc, mode, queries=Q, **kw):
    return (JaxAcquirer(songs, hc, queries=queries, mode=mode, seed=3, **kw),
            Acquirer(songs, hc, queries=queries, mode=mode, seed=3,
                     device="cpu", **kw))


def _inputs(rng, n_songs, *, nan_at=None):
    """Per-iteration inputs: one probs table over every song (an iteration
    feeds its live columns), wmc weights and rand keys (port, JAX)."""
    table = rng.dirichlet(np.ones(4), size=(M, n_songs)).astype(np.float32)
    out = []
    for it in range(ITERS):
        t = table
        if it == nan_at:
            t = table.copy()
            t[1] = np.nan                  # one member's rows: NaN
            t[:, 1::7] = 0.0               # songs with no valid row
        out.append((t, rng.random(M).astype(np.float32),
                    prng.fold_in(prng.key(7, "cpu"), it),
                    jax.random.fold_in(jax.random.key(7), it)))
    return out


def _select(acq, kw):
    """``select`` through the acquirer's seam, keeping the scoring result
    (its entropies)."""
    fn_key, inputs = acq.scoring_inputs(**kw)
    res = acq.run_scoring(fn_key, inputs)
    return acq.finish_select(res), res


def _run(jax_acq, port_acq, inputs, *, start=0, as_tensor=False):
    """Drive both acquirers through ``inputs[start:]``; returns the
    batches."""
    batches = []
    for table, weights, port_key, jax_key in inputs[start:]:
        live = np.flatnonzero(jax_acq.pool_mask)
        np.testing.assert_array_equal(live, np.flatnonzero(port_acq.pool_mask))
        kw_j, kw_p = {"rand_key": jax_key}, {"rand_key": port_key}
        if jax_acq.strategy.needs_probs:
            p = np.ascontiguousarray(table[:, live])
            kw_j["member_probs"] = jnp.asarray(p) if as_tensor else p
            kw_p["member_probs"] = torch.from_numpy(p) if as_tensor else p
        jax_acq.member_weights = port_acq.member_weights = weights
        q_jax, ref = _select(jax_acq, kw_j)
        q_port, got = _select(port_acq, kw_p)
        assert q_port == q_jax, (len(batches), q_port, q_jax)
        ge, re = got.entropy.numpy(), np.asarray(ref.entropy)
        np.testing.assert_array_equal(np.isneginf(ge), np.isneginf(re))
        live = ~np.isneginf(re)
        np.testing.assert_allclose(ge[live], re[live], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(port_acq.pool_mask, jax_acq.pool_mask)
        np.testing.assert_array_equal(port_acq.hc_mask, jax_acq.hc_mask)
        batches.append(q_port)
    return batches


def _assert_twins(acq):
    d = acq.device
    np.testing.assert_array_equal(d.pool_mask.numpy(), acq.pool_mask)
    if acq.strategy.uses_hc_table:
        np.testing.assert_array_equal(d.hc_mask.numpy(), acq.hc_mask)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_selects_as_jax_for_10_iterations(rng, mode, fuse):
    songs = [f"s{i:03d}" for i in range(300)]
    jax_acq, port_acq = _pair(songs, _hc(rng, 300), mode, fuse_step=fuse,
                              pad_to=600)
    assert port_acq.n_pad == jax_acq.n_pad == 600
    batches = _run(jax_acq, port_acq, _inputs(rng, 300, nan_at=4))
    assert sum(map(len, batches)) >= ITERS * Q // 2
    assert port_acq.take_h2d() == jax_acq.take_h2d()
    assert port_acq.device.n_revealed == jax_acq.device.n_revealed
    if fuse:
        _assert_twins(port_acq)


@pytest.mark.parametrize("mode", ["mc", "mix", "wmc", "qbdc"])
def test_tensor_probs_scatter_as_jax_device_arrays(rng, mode):
    songs = list(range(120))
    for fuse in (True, False):
        jax_acq, port_acq = _pair(songs, _hc(rng, 120), mode, fuse_step=fuse)
        _run(jax_acq, port_acq, _inputs(rng, 120), as_tensor=True)
        assert port_acq.device.probs.shape == (M, port_acq.n_pad, 4)


@pytest.mark.parametrize("mode", MODES)
def test_exhausting_pool_trims_minus_inf_slots(rng, mode):
    """37 songs, 4 per select: the last select has one valid row."""
    songs = [f"s{i:02d}" for i in range(37)]
    jax_acq, port_acq = _pair(songs, _hc(rng, 37), mode, queries=4)
    batches = _run(jax_acq, port_acq, _inputs(rng, 37))
    if mode != "mix":
        assert [len(b) for b in batches] == [4] * 9 + [1]
        assert port_acq.remaining_songs == []


@pytest.mark.parametrize("mode", MODES)
def test_replay_after_iteration_3_reaches_the_same_end_state(rng, mode):
    songs = [f"s{i:03d}" for i in range(200)]
    hc = _hc(rng, 200)
    inputs = _inputs(rng, 200)
    straight = _pair(songs, hc, mode)
    batches = _run(*straight, inputs)
    rebuilt = _pair(songs, hc, mode)
    for acq in rebuilt:
        acq.replay(batches[:3])
    assert _run(*rebuilt, inputs, start=3) == batches[3:]
    for acq in (rebuilt[1], straight[1]):
        np.testing.assert_array_equal(acq.pool_mask, straight[0].pool_mask)
        np.testing.assert_array_equal(acq.hc_mask, straight[0].hc_mask)
        _assert_twins(acq)


def test_replayed_twins_are_built_from_the_mirrors(rng):
    songs = list(range(50))
    hc = _hc(rng, 50)
    live_acq = Acquirer(songs, hc, queries=5, mode="mix", device="cpu")
    hist = [live_acq.select(rng.dirichlet(np.ones(4), (3, 50 - 5 * i))
                            .astype(np.float32)) for i in range(3)]
    rebuilt = Acquirer(songs, hc, queries=5, mode="mix", device="cpu")
    assert rebuilt.device.pool_mask is None      # built lazily
    rebuilt.replay(hist)
    d = rebuilt.device_masks()
    assert torch.equal(d.pool_mask, live_acq.device.pool_mask)
    assert torch.equal(d.hc_mask, live_acq.device.hc_mask)
    # the twins are copies: a select changes them, not the host array
    assert d.pool_mask.data_ptr() != rebuilt.pool_mask.ctypes.data


def test_staging_width_matches_jax():
    jax_acq, port_acq = _pair(list(range(700)), None, "mc", pad_to=1000)
    for n_live in (0, 1, 255, 256, 257, 700, 999, 1000):
        assert port_acq.staging_width(n_live) == jax_acq.staging_width(n_live)
    with pytest.raises(ValueError, match="live songs"):
        port_acq.select(torch.zeros((2, 5, 4)))


def test_sanitizer_matches_jax_and_is_identity_on_valid_rows(rng):
    p = rng.dirichlet(np.ones(4), size=(5, 30)).astype(np.float32)
    port = sanitize_member_rows(torch.from_numpy(p))
    np.testing.assert_array_equal(port.numpy(), p)
    p[1, 3] = np.nan
    p[0, 4, 2] = np.inf
    p[2, 5] = 0.0
    p[:, 6] = np.nan                       # no valid row: uniform
    ref = np.asarray(jax_sanitize(p))
    got = sanitize_member_rows(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[:, 6], 0.25)
    assert np.isfinite(got).all()


def test_mesh_and_unknown_mode_raise():
    """A mesh without a pool axis and an unknown mode raise; a pool mesh
    selects what the unmeshed acquirer selects (the sharded path itself
    is held in tests/test_torch_sharding.py and test_torch_sharded_loop.py)."""
    from consensus_entropy_tpu_torch.parallel.mesh import (
        make_pool_mesh,
        make_training_mesh,
    )

    with pytest.raises(ValueError, match="mesh"):
        Acquirer([1, 2], None, queries=1, mode="mc",
                 mesh=make_training_mesh(devices=["cpu"] * 2))
    probs = np.random.default_rng(0).uniform(0.01, 1, (2, 3, 4)).astype(
        np.float32)
    meshed = Acquirer([1, 2, 3], None, queries=1, mode="mc",
                      mesh=make_pool_mesh(["cpu"] * 2))
    plain = Acquirer([1, 2, 3], None, queries=1, mode="mc", device="cpu")
    assert meshed.n_pad == plain.n_pad == 8
    assert meshed.select(probs) == plain.select(probs)
    with pytest.raises(ValueError, match="unknown mode"):
        Acquirer([1, 2], None, queries=1, mode="zzz", device="cpu")
