"""Every scorer and fused step of the port's ``ops.scoring`` against
``consensus_entropy_tpu.ops.scoring`` on the CPU: entropies within the
repo's gate, equal indices where values > -inf, equal post-select masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.ops import scoring as jax_scoring
from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.ops import scoring

torch.set_num_threads(1)

# The repo's entropy gate (tests/test_pallas_scoring.py).
RTOL, ATOL = 1e-5, 1e-6
N, M, K = 240, 5, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_result(got, ref):
    """Entropies within the gate (same -inf rows), indices equal where
    values > -inf (ROADMAP C2)."""
    ge, re = got.entropy.numpy(), np.asarray(ref.entropy)
    np.testing.assert_array_equal(np.isneginf(ge), np.isneginf(re))
    live = ~np.isneginf(re)
    np.testing.assert_allclose(ge[live], re[live], rtol=RTOL, atol=ATOL)
    gv, rv = got.values.numpy(), np.asarray(ref.values)
    valid = rv > -np.inf
    np.testing.assert_array_equal(gv > -np.inf, valid)
    np.testing.assert_allclose(gv[valid], rv[valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.indices.numpy()[valid],
                                  np.asarray(ref.indices)[valid])


def _problem(seed, *, sparse=False):
    """Member probs with exact ties between songs, a zero row, an hc table
    rounded to 3 decimals (many exact ties), and masks; ``sparse`` leaves
    fewer valid rows than k."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(4), size=(M, N)).astype(np.float32)
    p[:, 40] = p[:, 10]
    p[:, 200] = p[:, 10]
    p[2, 7] = 0.0
    counts = rng.integers(0, 20, size=(N, 4)).astype(np.float64)
    counts[:, 0] += 1
    hc = np.round(counts / counts.sum(1, keepdims=True), 3).astype(np.float32)
    hc[[3, 90]] = 0.25          # the highest hc entropy, tied
    pool = rng.random(N) < 0.85
    hc_mask = rng.random(N) < 0.7
    if sparse:
        pool[:] = False
        pool[rng.choice(N, 4, replace=False)] = True
        hc_mask[:] = False
        hc_mask[rng.choice(N, 3, replace=False)] = True
    pool[[10, 40, 200]] = True
    return p, hc, pool, hc_mask


CASES = [(seed, sparse, tie) for seed, sparse in ((1, False), (2, True))
         for tie in ("fast", "numpy")]


@pytest.mark.parametrize("seed,sparse,tie", CASES)
def test_score_mc_qbdc_hc_match_jax(seed, sparse, tie):
    p, hc, pool, hc_mask = _problem(seed, sparse=sparse)
    member_mask = np.array([True, False, True, True, True])
    for mm in (None, member_mask):
        kw = {} if mm is None else {"member_mask": _t(mm)}
        jkw = {} if mm is None else {"member_mask": mm}
        for port_fn, jax_fn in ((scoring.score_mc, jax_scoring.score_mc),
                                (scoring.score_qbdc, jax_scoring.score_qbdc)):
            _assert_result(port_fn(_t(p), _t(pool), k=K, tie_break=tie, **kw),
                           jax_fn(p, pool, k=K, tie_break=tie, **jkw))
    _assert_result(scoring.score_hc(_t(hc), _t(hc_mask), k=K, tie_break=tie),
                   jax_scoring.score_hc(hc, hc_mask, k=K, tie_break=tie))
    hc_ent = np.asarray(jax_scoring.score_hc(hc, np.ones(N, bool),
                                             k=1).entropy)
    _assert_result(
        scoring.score_hc_precomputed(_t(hc_ent), _t(hc_mask), k=K,
                                     tie_break=tie),
        jax_scoring.score_hc_precomputed(hc_ent, hc_mask, k=K,
                                         tie_break=tie))


@pytest.mark.parametrize("seed,sparse,tie", CASES)
def test_score_mix_matches_jax_with_both_blocks(seed, sparse, tie):
    p, hc, pool, hc_mask = _problem(seed, sparse=sparse)
    got = scoring.score_mix(_t(p), _t(pool), _t(hc), _t(hc_mask), k=K,
                            tie_break=tie)
    ref = jax_scoring.score_mix(p, pool, hc, hc_mask, k=K, tie_break=tie)
    _assert_result(got, ref)
    valid = got.values.numpy() > -np.inf
    is_hc, slots = scoring.split_mix_index(got.indices, N)
    j_hc, j_slots = jax_scoring.split_mix_index(ref.indices, N)
    np.testing.assert_array_equal(is_hc.numpy()[valid], np.asarray(j_hc)[valid])
    np.testing.assert_array_equal(slots.numpy()[valid],
                                  np.asarray(j_slots)[valid])
    if not sparse:     # rows surface from both blocks
        assert set(is_hc.numpy()[valid]) == {False, True}


def test_wmc_weights_mask_and_fallback_match_jax():
    p, _, pool, _ = _problem(3)
    rng = np.random.default_rng(3)
    w = rng.random(M).astype(np.float32)
    mm = np.array([True, True, False, True, True])
    for weights, mask in ((w, None), (w, mm), (np.zeros(M, np.float32), None),
                          (np.array([0, 0, 1, 0, 0], np.float32), mm)):
        kw = {} if mask is None else {"member_mask": mask}
        ref = jax_scoring.score_wmc(p, pool, weights, k=K, **kw)
        got = scoring.score_wmc(_t(p), _t(pool), _t(weights), k=K,
                                **{k: _t(v) for k, v in kw.items()})
        _assert_result(got, ref)
        np.testing.assert_allclose(
            scoring.weighted_consensus_mean(
                _t(p), _t(weights),
                None if mask is None else _t(mask)).numpy(),
            np.asarray(jax_scoring.weighted_consensus_mean(p, weights, mask)),
            rtol=RTOL, atol=ATOL)


def test_wmc_equal_weights_is_bit_identical_to_mc_and_zero_falls_back():
    p, _, pool, _ = _problem(4)
    mc = scoring.score_mc(_t(p), _t(pool), k=K)
    for weights in (np.ones(M, np.float32), np.zeros(M, np.float32)):
        wmc = scoring.score_wmc(_t(p), _t(pool), _t(weights), k=K)
        for a, b in zip(mc, wmc):
            assert torch.equal(a, b)


def test_score_rand_matches_jax():
    pool = np.random.default_rng(5).random(N) < 0.6
    jk, tk = jax.random.key(42), prng.key(42, "cpu")
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        got = scoring.score_rand(tsub, _t(pool), k=K)
        ref = jax_scoring.score_rand(jsub, pool, k=K)
        for port, jax_out in zip(got, ref):     # scores, values, indices
            np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))


def _fused_args(key, seed, sparse):
    """Fresh (port, JAX) positional args of one fused step, and the
    positions of the pool mask and the hc mask it updates in place."""
    p, hc, pool, hc_mask = _problem(seed, sparse=sparse)
    weights = np.random.default_rng(seed).random(M).astype(np.float32)
    hc_ent = np.asarray(jax_scoring.score_hc(hc, np.ones(N, bool),
                                             k=1).entropy)
    if key == "rand_fused":
        return [prng.key(9, "cpu"), _t(pool)], \
            [jax.random.key(9), jnp.asarray(pool)], (1,)
    args, inplace = {
        "mc_fused": ((p, pool), (1,)),
        "qbdc_fused": ((p, pool), (1,)),
        "wmc_fused": ((p, pool, weights), (1,)),
        "hc_pre_fused": ((hc_ent, hc_mask, pool), (2, 1)),
        "mix_fused": ((p, pool, hc, hc_mask), (1, 3)),
    }[key]
    return [_t(a) for a in args], [jnp.asarray(a) for a in args], inplace


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("key", ["mc_fused", "qbdc_fused", "wmc_fused",
                                 "hc_pre_fused", "mix_fused", "rand_fused"])
def test_fused_steps_match_jax_and_update_masks_in_place(key, sparse):
    port_fns = scoring.make_scoring_fns(k=K)
    port_args, jax_args, inplace = _fused_args(key, 6, sparse)
    got = port_fns[key](*port_args)
    ref = jax_scoring.make_scoring_fns(k=K)[key](*jax_args)
    _assert_result(got, ref)
    assert got.pool_mask is port_args[inplace[0]]
    np.testing.assert_array_equal(got.pool_mask.numpy(),
                                  np.asarray(ref.pool_mask))
    if len(inplace) == 2:
        assert got.hc_mask is port_args[inplace[1]]
        np.testing.assert_array_equal(got.hc_mask.numpy(),
                                      np.asarray(ref.hc_mask))
    else:
        assert got.hc_mask is None and ref.hc_mask is None
    # the mode's unfused scorer on the same inputs selects the same rows
    fresh = _fused_args(key, 6, sparse)[0]
    base = port_fns[key[:-len("_fused")]](
        *(fresh[:2] if key == "hc_pre_fused" else fresh))
    for a, b in zip(base[:3], got[:3]):
        assert torch.equal(a, b)


def test_make_scoring_fns_has_the_jax_keys():
    assert set(scoring.make_scoring_fns(k=3)) == set(
        jax_scoring.make_scoring_fns(k=3))


def test_selection_scalars_pull_to_numpy():
    out = scoring.selection_scalars(torch.arange(4))
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 1, 2, 3]
    assert scoring.selection_scalars(np.arange(2)).tolist() == [0, 1]
