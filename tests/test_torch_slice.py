"""The port's slice end to end on the CPU: ``LinearPoolScorer`` runs AL
iterations of mc acquisition (fused consensus entropy -> top-k -> in-place
mask shrink) against a JAX loop of ``packed_score_mc`` (Pallas kernel in
interpret mode) followed by ``reveal_mask_update``."""

import numpy as np
import pytest
import torch

from consensus_entropy_tpu.experimental import pallas_scoring
from consensus_entropy_tpu.ops.topk import reveal_mask_update
from consensus_entropy_tpu_torch.al.linear_pool import LinearPoolScorer

torch.set_num_threads(1)

# The repo's entropy gate (tests/test_pallas_scoring.py).
RTOL, ATOL = 1e-5, 1e-6


def _problem(seed, m=3, n=200, k_frames=2, f=12, c=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k_frames, f)).astype(np.float32)
    w = (rng.standard_normal((m, f, c)) / np.sqrt(f)).astype(np.float32)
    b = (rng.standard_normal((m, c)) * 0.1).astype(np.float32)
    return x, w, b


def _jax_loop(x, w, b, *, iterations, k, tile_n):
    """The bench's Pallas iteration plus fused_mc's mask shrink, per step:
    (entropy, values, indices); and the final mask, trimmed to N."""
    n = x.shape[0]
    x_tiles, _ = pallas_scoring.pack_pool(x, tile_n)
    w_p, b_p = pallas_scoring.pack_weights(w, b)
    mask = np.zeros(x_tiles.shape[0] * tile_n, bool)
    mask[:n] = True
    steps = []
    for _ in range(iterations):
        ent, values, idx = pallas_scoring.packed_score_mc(
            x_tiles, w_p, b_p, mask, n_members=w.shape[0], k=k,
            interpret=True)
        mask = reveal_mask_update(mask, values, idx)
        steps.append((np.asarray(ent)[:n], np.asarray(values),
                      np.asarray(idx)))
    return steps, np.asarray(mask)[:n]


def _assert_step(port, ref):
    ent, values, idx = (t.numpy() for t in port[:3])
    ref_ent, ref_v, ref_i = ref
    live = ref_v > -np.inf
    np.testing.assert_array_equal(values > -np.inf, live)
    np.testing.assert_array_equal(idx[live], ref_i[live])
    np.testing.assert_array_equal(np.isneginf(ent), np.isneginf(ref_ent))
    fin = ~np.isneginf(ref_ent)
    np.testing.assert_allclose(ent[fin], ref_ent[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_slice_matches_jax_loop(impl):
    # 'kernel' on a CPU device goes through the kernel's wrapper, which runs
    # the plain version there (with the fused top-k merge semantics).
    x, w, b = _problem(7)
    ref_steps, ref_mask = _jax_loop(x, w, b, iterations=4, k=5, tile_n=64)
    scorer = LinearPoolScorer(x, w, b, device="cpu", impl=impl)
    for ref in ref_steps:
        _assert_step(scorer.step(5), ref)
    np.testing.assert_array_equal(scorer.pool_mask.numpy(), ref_mask)
    assert int(scorer.pool_mask.sum()) == 200 - 4 * 5


def test_slice_exhausts_the_pool():
    # 12 songs, 5 per step: the third step has 2 left and -inf slots that
    # must select nothing; the fourth selects nothing at all.
    x, w, b = _problem(11, n=12)
    ref_steps, ref_mask = _jax_loop(x, w, b, iterations=4, k=5, tile_n=8)
    scorer = LinearPoolScorer(x, w, b, device="cpu")
    for ref in ref_steps:
        _assert_step(scorer.step(5), ref)
    np.testing.assert_array_equal(scorer.pool_mask.numpy(), ref_mask)
    assert not scorer.pool_mask.any()


def test_run_returns_each_step_selection():
    x, w, b = _problem(3, n=60)
    stepped = LinearPoolScorer(x, w, b, device="cpu", impl="plain")
    expected = [stepped.step(4) for _ in range(3)]
    ran = LinearPoolScorer(x, w, b, device="cpu", impl="kernel").run(3, 4)
    assert len(ran) == 3
    for (idx, values), r in zip(ran, expected):
        np.testing.assert_array_equal(idx, r.indices.numpy())
        np.testing.assert_array_equal(values, r.values.numpy())
    assert len(np.unique(np.concatenate([i for i, _ in ran]))) == 12


def test_scorer_rejects_bad_configuration():
    x, w, b = _problem(5, n=10)
    with pytest.raises(ValueError):
        LinearPoolScorer(x, w, b, device="cpu", impl="xla")
    with pytest.raises(ValueError):
        LinearPoolScorer(x[..., :-1], w, b, device="cpu")
