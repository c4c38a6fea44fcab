"""The port's selection ops against ``consensus_entropy_tpu.ops`` on the CPU:
entropy, masked entropy, masked top-k (both tie policies), the mask shrink,
score_mc / fused_mc and the softmax-linear member."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import entropy as scipy_entropy

from consensus_entropy_tpu.ops import device_members as jax_members
from consensus_entropy_tpu.ops import entropy as jax_entropy
from consensus_entropy_tpu.ops import scoring as jax_scoring
from consensus_entropy_tpu.ops import topk as jax_topk
from consensus_entropy_tpu_torch.ops import device_members, entropy, scoring, topk

torch.set_num_threads(1)

# The repo's entropy gate (tests/test_pallas_scoring.py): float32 reductions
# taken in another order than XLA's.
RTOL, ATOL = 1e-5, 1e-6


def _probs(rng, shape, zero_frac=0.2):
    p = rng.random(shape).astype(np.float32)
    p[rng.random(shape) < zero_frac] = 0.0
    return p


def _assert_selection(port_v, port_i, ref_v, ref_i):
    """Indices equal where values > -inf (elsewhere they carry no meaning)."""
    port_v, ref_v = np.asarray(port_v), np.asarray(ref_v)
    live = ref_v > -np.inf
    np.testing.assert_array_equal(port_v > -np.inf, live)
    np.testing.assert_array_equal(np.asarray(port_i)[live],
                                  np.asarray(ref_i)[live])
    np.testing.assert_allclose(port_v[live], ref_v[live], rtol=RTOL,
                               atol=ATOL)


def test_shannon_entropy_matches_jax(rng):
    p = _probs(rng, (40, 4))
    p[3] = 0.0                # sums to zero
    p[4] = [0, 0, 1, 0]       # 0 log 0 = 0
    ref = np.asarray(jax_entropy.shannon_entropy(p))
    got = entropy.shannon_entropy(torch.from_numpy(p)).numpy()
    # A zero row is 0, as the JAX function (and the CUDA kernel) give it;
    # scipy gives NaN there and is held on the other rows.
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert got[3] == 0.0 == ref[3] and got[4] == 0.0
    live = np.arange(40) != 3
    np.testing.assert_allclose(got[live], scipy_entropy(p, axis=1)[live],
                               rtol=RTOL, atol=ATOL)


def test_shannon_entropy_along_dim_matches_jax(rng):
    p = _probs(rng, (3, 5, 6))
    ref = np.asarray(jax_entropy.shannon_entropy(p, axis=1))
    got = entropy.shannon_entropy(torch.from_numpy(p), dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_masked_entropy_matches_jax(rng):
    p = _probs(rng, (30, 4), zero_frac=0.0)
    mask = rng.random(30) < 0.6
    ref = np.asarray(jax_entropy.masked_entropy(p, mask))
    got = entropy.masked_entropy(torch.from_numpy(p),
                                 torch.from_numpy(mask)).numpy()
    assert np.all(np.isneginf(got[~mask]))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _ties(rng, n):
    """Scores with many exact ties (few distinct values)."""
    return rng.integers(0, 6, n).astype(np.float32)


@pytest.mark.parametrize("tie_break", ["fast", "numpy"])
@pytest.mark.parametrize("n,k,valid_frac", [
    (50, 10, 0.8),      # ties within one row
    (3000, 25, 0.9),    # past JAX's two-stage split (rows of 1024)
    (40, 12, 0.15),     # fewer valid rows than k
])
def test_masked_top_k_matches_jax(rng, tie_break, n, k, valid_frac):
    scores = _ties(rng, n)
    mask = rng.random(n) < valid_frac
    ref_v, ref_i = jax_topk.masked_top_k(scores, mask, k, tie_break)
    v, i = topk.masked_top_k(torch.from_numpy(scores),
                             torch.from_numpy(mask), k, tie_break)
    assert v.shape == (k,) and i.shape == (k,)
    _assert_selection(v.numpy(), i.numpy(), ref_v, ref_i)
    assert int(topk.valid_count(v)) == int(jax_topk.valid_count(ref_v))


def test_masked_top_k_fixes_tie_order():
    # torch.topk leaves the order of ties open; the port must not.
    scores = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    mask = torch.ones(5, dtype=torch.bool)
    assert topk.masked_top_k(scores, mask, 3, "fast")[1].tolist() == [1, 2, 4]
    assert topk.masked_top_k(scores, mask, 3, "numpy")[1].tolist() == [4, 2, 1]
    with pytest.raises(ValueError):
        topk.masked_top_k(scores, mask, 3, "random")


def test_reveal_mask_update_matches_jax_in_place(rng):
    mask = rng.random(20) < 0.7
    values = np.array([0.9, 0.5, 0.5, -np.inf, -np.inf], np.float32)
    indices = np.array([3, 7, 7, 11, 0])      # -inf slots must be ignored
    ref = np.asarray(jax_topk.reveal_mask_update(mask, values, indices))
    port = torch.from_numpy(mask.copy())
    out = topk.reveal_mask_update(port, torch.from_numpy(values),
                                  torch.from_numpy(indices))
    assert out is port
    np.testing.assert_array_equal(port.numpy(), ref)
    assert port[11] == bool(mask[11]) and port[0] == bool(mask[0])


@pytest.mark.parametrize("member_mask", [None, [True, False, True, True]])
def test_consensus_mean_matches_jax(rng, member_mask):
    p = _probs(rng, (4, 25, 4))
    mm = None if member_mask is None else np.array(member_mask)
    ref = np.asarray(jax_scoring.consensus_mean(p, mm))
    got = scoring.consensus_mean(
        torch.from_numpy(p), None if mm is None else torch.from_numpy(mm))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tie_break", ["fast", "numpy"])
def test_score_mc_matches_jax(rng, tie_break):
    p = rng.dirichlet(np.ones(4), size=(5, 200)).astype(np.float32)
    p[:, 40] = p[:, 10]            # an exact tie between two songs
    mask = rng.random(200) < 0.8
    mask[[10, 40]] = True
    ref = jax_scoring.score_mc(p, mask, k=12, tie_break=tie_break)
    got = scoring.score_mc(torch.from_numpy(p), torch.from_numpy(mask), k=12,
                           tie_break=tie_break)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(ref.entropy),
                               rtol=RTOL, atol=ATOL)
    _assert_selection(got.values.numpy(), got.indices.numpy(), ref.values,
                      ref.indices)


def test_fused_mc_matches_jax(rng):
    p = rng.dirichlet(np.ones(4), size=(3, 60)).astype(np.float32)
    mask = np.zeros(60, bool)
    mask[rng.choice(60, 10, replace=False)] = True   # fewer valid than k
    ref = jax_scoring.fused_mc(jnp.asarray(p), jnp.asarray(mask), k=16)
    port_mask = torch.from_numpy(mask.copy())
    got = scoring.fused_mc(torch.from_numpy(p), port_mask, k=16)
    assert got.pool_mask is port_mask
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(ref.pool_mask))
    _assert_selection(got.values.numpy(), got.indices.numpy(), ref.values,
                      ref.indices)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(ref.entropy),
                               rtol=RTOL, atol=ATOL)
    assert not port_mask.any()


def test_linear_softmax_probs_matches_jax(rng):
    x = rng.standard_normal((30, 12)).astype(np.float32)
    coef = rng.standard_normal((4, 12)).astype(np.float32)
    intercept = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jax_members.linear_softmax_probs(x, coef, intercept))
    got = device_members.linear_softmax_probs(
        torch.from_numpy(x), torch.from_numpy(coef),
        torch.from_numpy(intercept))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
