"""The port's fleet scorer families against its single-user scorers and the
JAX package's fleet families, on the CPU.

For all 16 keys of ``make_fleet_scoring_fns`` a cohort of U = 3 seeded
users (padded pools with holes, quarantine member masks) goes through one
stacked call.  Each row is bit-equal with that user's single call in the
port (tolerance 0: the same ops on the same values).  Against JAX's vmapped
families the rows agree as the single scorers do: entropies and values
within the repo's gate (rtol 1e-5 / atol 1e-6), indices and post-select
masks equal where values > -inf; ``rand``'s draws are bit-equal with JAX's
stacked draws.  The width-guarded families refuse a mis-padded cohort, and
after a stacked fused dispatch through the scheduler each user's device
mask twins equal what its own fused call leaves, in its own tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.ops import entropy as jax_entropy
from consensus_entropy_tpu.ops import scoring as jax_scoring
from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.al.acquisition import Acquirer
from consensus_entropy_tpu_torch.fleet.scheduler import FleetScheduler
from consensus_entropy_tpu_torch.ops import scoring
from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6  # the repo's entropy gate
U, M, N, C, K = 3, 5, 96, 4, 6
SEEDS = (11, 12, 13)

#: each key's per-user operands, by name
OPERANDS = {
    "mc": ("probs", "pool"), "mc_masked": ("probs", "pool", "members"),
    "hc": ("hc", "hc_mask"), "hc_pre": ("hc_ent", "hc_mask"),
    "mix": ("probs", "pool", "hc", "hc_mask"),
    "mix_masked": ("probs", "pool", "hc", "hc_mask", "members"),
    "rand": ("key", "pool"), "qbdc": ("probs", "pool"),
    "wmc": ("probs", "pool", "weights"),
    "wmc_masked": ("probs", "pool", "weights", "members"),
    "mc_fused": ("probs", "pool"), "qbdc_fused": ("probs", "pool"),
    "wmc_fused": ("probs", "pool", "weights"),
    "rand_fused": ("key", "pool"),
    "hc_pre_fused": ("hc_ent", "hc_mask", "pool"),
    "mix_fused": ("probs", "pool", "hc", "hc_mask"),
}


@pytest.fixture(scope="module")
def cohort():
    """Per-user numpy operands: normalized probs, pools of 80 live rows
    with holes, hc tables, weights, member masks, seeds."""
    rng = np.random.default_rng(1987)
    users = []
    for seed in SEEDS:
        p = rng.uniform(0.01, 1.0, (M, N, C)).astype(np.float32)
        hc = rng.uniform(0.0, 1.0, (N, C)).astype(np.float32)
        pool = np.zeros(N, bool)
        pool[:80] = True
        pool[rng.choice(80, 3, replace=False)] = False
        hc_mask = pool.copy()
        hc_mask[rng.choice(80, 5, replace=False)] = False
        members = np.ones(M, bool)
        members[rng.integers(M)] = False
        users.append({
            "probs": p / p.sum(-1, keepdims=True), "pool": pool, "hc": hc,
            "hc_mask": hc_mask,
            "weights": rng.uniform(0.2, 2.0, M).astype(np.float32),
            "members": members, "seed": seed})
    return users


def _port_operand(u, name):
    if name == "key":
        return prng.key(u["seed"], "cpu")
    if name == "hc_ent":
        return shannon_entropy(torch.from_numpy(u["hc"]))
    return torch.from_numpy(np.array(u[name]))


def _jax_operand(u, name):
    if name == "key":
        return jax.random.key(u["seed"])
    if name == "hc_ent":
        return jax_entropy.shannon_entropy(jnp.asarray(u["hc"]))
    return jnp.asarray(u[name])


def _single(key):
    """The port's single-user call of ``key`` (the masked variants are
    the scorers with their member mask)."""
    fns = scoring.make_scoring_fns(k=K)
    base = key[: -len("_masked")] if key.endswith("_masked") else None
    if base is None:
        return fns[key]
    return {"mc": lambda p, m, mm: scoring.score_mc(
                p, m, k=K, member_mask=mm),
            "mix": lambda p, m, h, hm, mm: scoring.score_mix(
                p, m, h, hm, k=K, member_mask=mm),
            "wmc": lambda p, m, w, mm: scoring.score_wmc(
                p, m, w, k=K, member_mask=mm)}[base]


def _stacked(users, names):
    return [torch.stack([_port_operand(u, n) for u in users])
            for n in names]


@pytest.mark.parametrize("key", sorted(OPERANDS))
def test_fleet_rows_equal_single_calls(cohort, key):
    """Tolerance 0: each row of the stacked call is its user's call."""
    names = OPERANDS[key]
    out = scoring.make_fleet_scoring_fns(k=K)[key](*_stacked(cohort, names))
    for i, u in enumerate(cohort):
        one = _single(key)(*[_port_operand(u, n) for n in names])
        for field, got, ref in zip(out._fields, out, one):
            if ref is None:
                assert got is None
                continue
            assert torch.equal(got[i], ref), (key, field, i)


@pytest.mark.parametrize("key", sorted(OPERANDS))
def test_fleet_rows_match_jax_fleet(cohort, key):
    """Against the JAX vmapped family: values within the gate, indices
    and post-select masks equal where values > -inf."""
    names = OPERANDS[key]
    ours = scoring.make_fleet_scoring_fns(k=K)[key](*_stacked(cohort, names))
    jax_in = []
    for n in names:
        vals = [_jax_operand(u, n) for u in cohort]
        jax_in.append(jax_scoring.stack_user_keys(vals) if n == "key"
                      else jnp.stack(vals))
    theirs = jax_scoring.make_fleet_scoring_fns(k=K)[key](*jax_in)
    for field, got, ref in zip(ours._fields, ours, theirs):
        if ref is None:
            assert got is None
            continue
        got, ref = got.numpy(), np.asarray(ref)
        if field in ("entropy", "values"):
            np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
            live = ~np.isneginf(ref)
            np.testing.assert_allclose(got[live], ref[live], rtol=RTOL,
                                       atol=ATOL)
        elif field == "indices":
            valid = np.asarray(theirs.values) > -np.inf
            np.testing.assert_array_equal(got[valid], ref[valid])
        else:  # the post-select masks
            np.testing.assert_array_equal(got, ref)


def test_rand_rows_are_jax_stacked_draws(cohort):
    """``rand``'s scores are the uniform draws themselves: bit-equal with
    JAX's stacked draws (``jax_threefry_partitionable``)."""
    ours = scoring.make_fleet_scoring_fns(k=K)["rand"](
        *_stacked(cohort, ("key", "pool")))
    keys = jax_scoring.stack_user_keys(
        [jax.random.key(u["seed"]) for u in cohort])
    theirs = jax_scoring.make_fleet_scoring_fns(k=K)["rand"](
        keys, jnp.stack([jnp.asarray(u["pool"]) for u in cohort]))
    np.testing.assert_array_equal(ours.entropy.numpy(),
                                  np.asarray(theirs.entropy))
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(theirs.indices))
    np.testing.assert_array_equal(
        prng.uniform_rows(scoring.stack_user_keys(
            [prng.key(s, "cpu") for s in SEEDS]), N).numpy(),
        np.asarray(theirs.entropy))
    assert scoring.is_key_array(scoring.stack_user_keys(
        [prng.key(1, "cpu")]))
    assert not scoring.is_key_array(torch.zeros(2))


def test_width_guard_refuses_a_mispadded_cohort(cohort):
    guarded = scoring.fleet_scoring_fns_for_width(k=K, width=N)
    stacked = _stacked(cohort, ("probs", "pool"))
    ref = scoring.make_fleet_scoring_fns(k=K)["mc"](*stacked)
    assert torch.equal(guarded["mc"](*stacked).indices, ref.indices)
    assert sorted(guarded) == sorted(OPERANDS)
    wide = scoring.fleet_scoring_fns_for_width(k=K, width=2 * N)
    for key in ("mc", "mc_masked", "rand_fused", "hc_pre_fused"):
        with pytest.raises(ValueError, match="bucket routing error"):
            wide[key](*_stacked(cohort, OPERANDS[key]))


@pytest.mark.parametrize("mode", ["mc", "hc", "mix", "rand", "wmc",
                                  "qbdc"])
def test_stacked_fused_dispatch_leaves_each_twin_as_its_single_call(
        cohort, mode):
    """Three acquirers select twice through the scheduler's stacked path,
    three through their own fused calls: the same songs, and each device
    twin equal to its single run's, held in the acquirer's own tensor (not
    a view of the cohort's stacked buffer)."""
    songs = list(range(100, 100 + 80))

    def acquirers():
        return [Acquirer(songs, u["hc"][:80], queries=K, mode=mode,
                         seed=u["seed"], pad_to=N, device="cpu")
                for u in cohort]

    single, fleet = acquirers(), acquirers()
    owned = None
    for it in range(2):
        steps = []
        for i, (a, b) in enumerate(zip(single, fleet)):
            probs = cohort[i]["probs"][:, :80] * (1 + it)
            if mode == "wmc":
                a.member_weights = b.member_weights = cohort[i]["weights"]
            rand_key = prng.key(cohort[i]["seed"] + it, "cpu")
            steps.append(b.scoring_inputs(probs.copy(), rand_key=rand_key))
            assert a.select(probs.copy(), rand_key=rand_key) is not None
        fn_key = steps[0][0]
        assert fn_key.endswith("_fused")
        if owned is None:
            owned = [b.device_masks().pool_mask for b in fleet]
        stacked = [torch.stack([s[1][p] for s in steps]) if not
                   scoring.is_key_array(steps[0][1][p]) else
                   scoring.stack_user_keys([s[1][p] for s in steps])
                   for p in range(len(steps[0][1]))]
        batched = scoring.make_fleet_scoring_fns(k=K)[fn_key](*stacked)

        class Step:
            def __init__(self, inputs):
                self.inputs = inputs

        rows = FleetScheduler._result_rows(
            fn_key, batched, [(None, Step(s[1])) for s in steps])
        for b, (_, res) in zip(fleet, rows):
            b.finish_select(res)
    for a, b, own in zip(single, fleet, owned):
        da, db = a.device_masks(), b.device_masks()
        assert torch.equal(da.pool_mask, db.pool_mask)
        assert db.pool_mask is own and db.pool_mask._base is None
        if da.hc_mask is not None:
            assert torch.equal(da.hc_mask, db.hc_mask)
            assert db.hc_mask._base is None
        np.testing.assert_array_equal(a.pool_mask, b.pool_mask)
        assert a.remaining_songs == b.remaining_songs
