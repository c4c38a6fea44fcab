"""The port's pool-sharded selects against its unsharded scorers and the
JAX package, on the CPU.

Meshes of 1, 2 and 4 CPU entries.  Every key of ``make_sharded_scoring_
fns`` and ``make_sharded_step_fns`` gives, against the port's unsharded
function, bit-equal entropies, values and masks and equal indices (where
values > -inf, C2), ties included, for both tie policies; against the JAX
package (its unsharded scorers, and for the seven keys of
``parallel/sharding.py`` its sharded families on the conftest's 8 virtual
devices) the values agree within the entropy gate (rtol 1e-5, atol 1e-6)
and the indices are equal.  The fused steps update the sharded masks in
place.  The written-out mc scorer sends ties to the lowest global index,
as JAX's ``make_shardmap_mc_scorer`` does.  B2's plain path (each shard's
``linear_score_mc(fuse_topk=True)`` on CPU tensors) equals the port's
unsharded call and agrees with JAX's ``packed_score_mc`` of the whole pool
(Pallas interpret mode) within the gate.  The fleet family keeps both its
guards; the sharded scatter and probs buffer place rows as the unsharded
``index_copy_`` does."""

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.experimental import pallas_scoring
from consensus_entropy_tpu.ops import scoring as jax_scoring
from consensus_entropy_tpu.parallel import make_pool_mesh as jax_pool_mesh
from consensus_entropy_tpu.parallel import sharding as jax_sharding
from consensus_entropy_tpu_torch import convert, prng
from consensus_entropy_tpu_torch.kernels import linear_mc
from consensus_entropy_tpu_torch.ops import scoring
from consensus_entropy_tpu_torch.ops.entropy import shannon_entropy
from consensus_entropy_tpu_torch.parallel import pool_mesh, sharding
from consensus_entropy_tpu_torch.parallel.mesh import (
    ShardedRows,
    make_pool_mesh,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
M, N, C, K = 3, 64, 4, 6
SEVEN = ("mc", "hc", "hc_pre", "mix", "rand", "qbdc", "wmc")


@pytest.fixture(scope="module")
def ops():
    """Operands with exact ties across shard boundaries (rows 5, 21, 40
    and 60 share one distribution) and masked rows."""
    rng = np.random.default_rng(42)
    p = rng.uniform(0.01, 1.0, (M, N, C)).astype(np.float32)
    p[:, [21, 40, 60]] = p[:, [5]]
    hc = rng.uniform(0, 1, (N, C)).astype(np.float32)
    hc[[30, 50]] = hc[3]
    return {"probs": p,
            "pool_mask": rng.uniform(size=N) > 0.2,
            "hc_freq": hc,
            "hc_mask": rng.uniform(size=N) > 0.3,
            "hc_ent": shannon_entropy(torch.from_numpy(hc)).numpy(),
            "weights": rng.uniform(0.5, 2, M).astype(np.float32),
            "seed": 17}


def _args(ops, key, torch_side=True):
    names = pool_mesh._OPERANDS[key]
    out = []
    for name in names:
        if name == "key":
            out.append(prng.key(ops["seed"], "cpu") if torch_side
                       else jax.random.key(ops["seed"]))
        else:
            v = ops[name].copy()
            out.append(torch.from_numpy(v) if torch_side else v)
    return out


def _np(x):
    if isinstance(x, ShardedRows):
        x = x.full()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_select(got, ref, *, exact):
    gv, rv = _np(got.values), _np(ref.values)
    live = rv > -np.inf
    np.testing.assert_array_equal(gv > -np.inf, live)
    np.testing.assert_array_equal(_np(got.indices)[live],
                                  _np(ref.indices)[live])
    ge, re_ = _np(got.entropy), _np(ref.entropy)
    if exact:
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(ge, re_)
    else:
        np.testing.assert_allclose(gv[live], rv[live], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.isneginf(ge), np.isneginf(re_))
        fin = ~np.isneginf(re_)
        np.testing.assert_allclose(ge[fin], re_[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tie_break", ["fast", "numpy"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_every_step_key_matches_unsharded_and_jax(ops, n_dev, tie_break):
    mesh = make_pool_mesh(["cpu"] * n_dev)
    fns = pool_mesh.make_sharded_step_fns(mesh, k=K, tie_break=tie_break)
    plain = scoring.make_scoring_fns(k=K, tie_break=tie_break)
    theirs = jax_scoring.make_scoring_fns(k=K, tie_break=tie_break)
    assert set(fns) == set(plain) == set(theirs)
    for key in fns:
        got = fns[key](*_args(ops, key))
        _assert_select(got, plain[key](*_args(ops, key)), exact=True)
        _assert_select(got, theirs[key](*_args(ops, key, False)),
                       exact=False)
        if key.endswith("_fused"):
            ref = theirs[key](*_args(ops, key, False))
            np.testing.assert_array_equal(_np(got.pool_mask),
                                          np.asarray(ref.pool_mask))
            if ref.hc_mask is not None:
                np.testing.assert_array_equal(_np(got.hc_mask),
                                              np.asarray(ref.hc_mask))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_seven_keys_match_jax_sharded_families(ops, n_dev):
    mesh = make_pool_mesh(["cpu"] * n_dev)
    fns = sharding.make_sharded_scoring_fns(mesh, k=K)
    assert set(fns) == set(SEVEN)
    theirs = jax_sharding.make_sharded_scoring_fns(jax_pool_mesh(), k=K)
    for key in SEVEN:
        _assert_select(fns[key](*_args(ops, key)),
                       theirs[key](*_args(ops, key, False)), exact=False)


def test_fused_steps_update_the_sharded_masks_in_place(ops):
    mesh = make_pool_mesh(["cpu"] * 4)
    fns = pool_mesh.make_sharded_step_fns(mesh, k=K)
    devs = mesh.axis_devices("pool")
    for key in ("mc_fused", "hc_pre_fused", "mix_fused", "rand_fused"):
        args = _args(ops, key)
        sharded = [ShardedRows.split(a, devs, -1) if a.dtype == torch.bool
                   else a for a in args]
        blocks = {id(b) for a in sharded if isinstance(a, ShardedRows)
                  for b in a.blocks}
        before = [a.full().clone() for a in sharded
                  if isinstance(a, ShardedRows)]
        res = fns[key](*sharded)
        pool_pos, hc_pos = scoring.FUSED_MASKS[key]
        assert res.pool_mask is sharded[pool_pos]
        assert (res.hc_mask is None) == (hc_pos is None)
        if hc_pos is not None:
            assert res.hc_mask is sharded[hc_pos]
        after = [a.full() for a in sharded if isinstance(a, ShardedRows)]
        assert {id(b) for a in sharded if isinstance(a, ShardedRows)
                for b in a.blocks} == blocks
        assert any(not torch.equal(a, b) for a, b in zip(before, after))
        ref = scoring.make_scoring_fns(k=K)[key](*_args(ops, key))
        assert torch.equal(res.pool_mask.full(), ref.pool_mask)


def test_shardmap_mc_scorer_ties_go_to_the_lowest_global_index():
    """32 equal top rows, every other row of each shard: the written-out
    scorer returns the first eight in global index order, as JAX's does
    on its 8-device mesh."""
    p = np.full((2, 64, 4), 0.25, np.float32)
    p[:, 1::2] = [0.7, 0.1, 0.1, 0.1]
    mask = np.ones(64, bool)
    ours = sharding.make_shardmap_mc_scorer(make_pool_mesh(["cpu"] * 4),
                                            k=8)(torch.from_numpy(p),
                                                 torch.from_numpy(mask))
    theirs = jax_sharding.make_shardmap_mc_scorer(jax_pool_mesh(), k=8)(
        p, mask)
    np.testing.assert_array_equal(ours.indices.numpy(), np.arange(0, 16, 2))
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(theirs.indices))
    np.testing.assert_allclose(ours.values.numpy(),
                               np.asarray(theirs.values), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_b2_plain_path_matches_unsharded_and_jax_kernel(n_dev):
    rng = np.random.default_rng(7)
    n, kf, f, m, k = 256, 2, 12, 3, 10
    x = rng.standard_normal((n, kf, f)).astype(np.float32)
    x[[70, 200]] = x[9]     # ties across shards
    w = (rng.standard_normal((m, f, C)) / np.sqrt(f)).astype(np.float32)
    b = (rng.standard_normal((m, C)) * 0.1).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    w_p, b_p = convert.linear_members_from_jax(w, b, device="cpu")
    scorer = sharding.make_shardmap_pallas_mc_scorer(
        make_pool_mesh(["cpu"] * n_dev), n_members=m, k=k)
    got = scorer(torch.from_numpy(x), w_p, b_p, torch.from_numpy(mask))
    assert isinstance(got.entropy, ShardedRows)
    plain = linear_mc.linear_score_mc(
        torch.from_numpy(x), w_p, b_p, torch.from_numpy(mask),
        n_members=m, k=k, fuse_topk=True)
    _assert_select(got, scoring.ScoreResult(*plain), exact=True)
    x_tiles, _ = pallas_scoring.pack_pool(x, 128)
    jw, jb = pallas_scoring.pack_weights(w, b)
    ent, values, idx = pallas_scoring.packed_score_mc(
        x_tiles, jw, jb, mask, n_members=m, k=k, fuse_topk=True,
        interpret=True)
    _assert_select(got, scoring.ScoreResult(ent, values, idx), exact=False)


def test_sharded_fleet_family_and_its_guards(ops):
    mesh = make_pool_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="does not divide across"):
        pool_mesh.sharded_fleet_fns_for_width(make_pool_mesh(["cpu"] * 4),
                                              k=2, width=10)
    fns = pool_mesh.sharded_fleet_fns_for_width(mesh, k=K, width=N)
    plain = scoring.make_fleet_scoring_fns(k=K)
    assert set(fns) == set(plain)
    probs = torch.stack([torch.from_numpy(ops["probs"])] * 3)
    probs[1] = probs[1].flip(1)
    masks = torch.stack([torch.from_numpy(ops["pool_mask"])] * 3)
    mm = torch.tensor([[True, False, True]] * 3)
    for key, args in (("mc", (probs, masks)),
                      ("mc_masked", (probs, masks, mm)),
                      ("rand", (scoring.stack_user_keys(
                          [prng.key(i, "cpu") for i in range(3)]), masks))):
        _assert_select(fns[key](*args), plain[key](*args), exact=True)
    got = fns["mc_fused"](probs, masks.clone())
    ref = plain["mc_fused"](probs, masks.clone())
    assert torch.equal(got.pool_mask.full(), ref.pool_mask)
    assert torch.equal(got.pool_mask[1].full(), ref.pool_mask[1])
    with pytest.raises(ValueError, match="bucket routing error"):
        fns["mc"](probs[:, :, :32], masks[:, :32])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_scatter_and_probs_buffer(n_dev):
    mesh = make_pool_mesh(["cpu"] * n_dev)
    buf = pool_mesh.sharded_probs_buffer(mesh, 2, 16, C)
    assert [b.shape for b in buf.blocks] == [(2, 16 // n_dev, C)] * n_dev
    assert torch.equal(buf.full(), torch.zeros(2, 16, C))
    rows = torch.tensor([1, 4, 7, 10, 15, 16, 16])   # 16: dropped tail
    p = torch.arange(2 * 7 * C, dtype=torch.float32).reshape(2, 7, C)
    out = pool_mesh.sharded_scatter_rows(mesh)(buf, rows, p)
    assert out is buf
    ref = torch.zeros(2, 16, C)
    ref.index_copy_(1, rows[:5], p[:, :5])
    assert torch.equal(buf.full(), ref)
