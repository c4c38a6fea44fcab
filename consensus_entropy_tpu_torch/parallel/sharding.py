"""Pool-sharded selects: each shard scores its rows, only candidates move.

Counterpart of ``consensus_entropy_tpu/parallel/sharding.py``.  A select
over a :class:`~consensus_entropy_tpu_torch.parallel.mesh.ShardedRows`
pool runs in four steps:

1. the port's single-device function on each shard's block, on that
   block's device (replicated operands are copied once per distinct
   device);
2. ``k`` candidates per block (its own top-k);
3. local indices made global and gathered to the first shard's device;
4. one stable top-k over the candidates, ordered by global index first,
   so ties resolve as the unsharded select resolves them (``_merge_local_
   topk``, ``sharding.py:97-106``; ``'numpy'`` ties too).

Every reduction of a select (member mean, class entropy) is row-local, so
on one device type the sharded result is bit-equal to the unsharded one.
``rand`` draws the whole pool's uniforms on the first device (the bits of
``score_rand``) and splits them.  ``mix`` ranks the concatenated
``[mc; hc]`` row space; its entropy comes back whole on the first device.

:func:`make_shardmap_pallas_mc_scorer` (B2) runs the hand kernel
``kernels.linear_mc.linear_score_mc(..., fuse_topk=True)`` on each shard's
song-major ``(N_s, K, F)`` rows.
"""

from __future__ import annotations

import numpy as np
import torch

from consensus_entropy_tpu_torch import prng
from consensus_entropy_tpu_torch.ops.scoring import (
    FusedStepResult,
    ScoreResult,
    split_mix_index,
)
from consensus_entropy_tpu_torch.ops.topk import (
    masked_top_k,
    reveal_mask_update,
)
from consensus_entropy_tpu_torch.parallel import multihost
from consensus_entropy_tpu_torch.parallel.mesh import Mesh, ShardedRows


def _layout(args) -> ShardedRows:
    """The row layout the sharded operands of one call share."""
    sharded = [a for a in args if isinstance(a, ShardedRows)]
    if not sharded:
        raise ValueError("a sharded call needs at least one ShardedRows "
                         "operand")
    def layout(a):
        return (a.offsets, [a.block_len(s) for s in range(len(a.blocks))],
                a.n, a.devices)

    first = sharded[0]
    for a in sharded[1:]:
        if layout(a) != layout(first):
            raise ValueError("sharded operands disagree in row layout")
    return first


def run_blocks(fn, args, layout: ShardedRows) -> list:
    """``fn`` on each shard: a :class:`ShardedRows` operand gives its
    block, a tensor on another device is copied there once per distinct
    device, anything else passes as is."""
    copies: dict = {}
    outs = []
    for s, dev in enumerate(layout.devices):
        local = []
        for pos, a in enumerate(args):
            if isinstance(a, ShardedRows):
                a = a.blocks[s]
            elif isinstance(a, torch.Tensor) and a.device != dev:
                if (pos, dev) not in copies:
                    copies[(pos, dev)] = a.to(dev)
                a = copies[(pos, dev)]
            local.append(a)
        outs.append(fn(*local))
    return outs


def merge_topk(values: list, indices: list, k: int,
               tie_break: str = "fast"):
    """The global top-``k`` of per-shard candidates ``(..., k_s)`` with
    GLOBAL indices, on the first list entry's device: this process's
    candidates, then every other rank's (``multihost.gather_ranks``), are
    put in global-index order, and one stable top-k ranks them, so a tie
    goes where the unsharded ``masked_top_k`` sends it."""
    dev = values[0].device
    v = multihost.gather_ranks(torch.cat([x.to(dev) for x in values], -1))
    gi = multihost.gather_ranks(torch.cat([x.to(dev) for x in indices],
                                          -1))
    order = torch.sort(gi, dim=-1, stable=True).indices
    v, gi = v.gather(-1, order), gi.gather(-1, order)
    top_v, j = masked_top_k(v, torch.ones_like(v, dtype=torch.bool), k,
                            tie_break)
    return top_v, gi.gather(-1, j)


def sharded_select(fn, args, *, k: int, tie_break: str = "fast",
                   mix: bool = False) -> ScoreResult:
    """One select over row-sharded operands: ``fn`` (a single-device
    scorer returning a :class:`ScoreResult`) on every shard, then the
    candidate merge.  The entropy stays sharded, except mix's, which is
    the ``[mc; hc]`` row space whole on the first device."""
    layout = _layout(args)
    outs = run_blocks(fn, args, layout)
    n, gis = layout.n, []
    for s, o in enumerate(outs):
        off, nb = layout.offsets[s], layout.block_len(s)
        gi = o.indices + off
        if mix:   # local [mc (nb); hc (nb)] -> global [mc (n); hc (n)]
            gi = torch.where(o.indices < nb, gi, o.indices - nb + n + off)
        gis.append(gi)
    values, indices = merge_topk([o.values for o in outs], gis, k,
                                 tie_break)
    ents = [o.entropy for o in outs]
    if mix:
        dev = values.device
        halves = [e.to(dev) for e in ents]
        nbs = [layout.block_len(s) for s in range(len(ents))]
        entropy = torch.cat([
            multihost.gather_ranks(torch.cat(
                [e[..., :nb] for e, nb in zip(halves, nbs)], -1)),
            multihost.gather_ranks(torch.cat(
                [e[..., nb:] for e, nb in zip(halves, nbs)], -1))], -1)
    else:
        entropy = ShardedRows(ents, ents[0].dim() - 1, layout.offsets, n)
    return ScoreResult(entropy, values, indices)


def sharded_rand(key: torch.Tensor, pool_mask: ShardedRows, *,
                 k: int) -> ScoreResult:
    """rand over a sharded mask: the uniforms of the whole pool drawn on
    the first shard's device (``score_rand``'s bits, one row per key of a
    ``(U, 2)`` batch), cut into the mask's blocks, ranked shard by
    shard."""
    dev = pool_mask.device
    if key.dim() == 2:
        scores = prng.uniform_rows(key, pool_mask.n, device=dev)
    else:
        scores = prng.uniform(key, pool_mask.shape, device=dev)
    scores = ShardedRows(
        [scores[..., off: off + pool_mask.block_len(s)].to(d)
         for s, (off, d) in enumerate(zip(pool_mask.offsets,
                                          pool_mask.devices))],
        scores.dim() - 1, pool_mask.offsets, pool_mask.n)

    def local(s, m):
        return ScoreResult(s, *masked_top_k(s, m, k, "fast"))

    return sharded_select(local, (scores, pool_mask), k=k)


def clear_rows(mask: ShardedRows, values: torch.Tensor,
               slots: torch.Tensor) -> ShardedRows:
    """The fused steps' mask shrink on a sharded mask, in place: each
    block clears the selected slots that fall in its rows (slots with a
    ``-inf`` value are ignored, as ``reveal_mask_update`` ignores them)."""
    for s, block in enumerate(mask.blocks):
        off, nb = mask.offsets[s], mask.block_len(s)
        local = (slots - off).to(block.device)
        mine = (local >= 0) & (local < nb)
        v = torch.where(mine, values.to(block.device), float("-inf"))
        reveal_mask_update(block, v, local.clamp(0, nb - 1))
    return mask


def fused_step(base, pool_pos: int, hc_pos: int | None, n_base: int,
               mix: bool):
    """A fused step over sharded operands: the sharded select ``base`` on
    the first ``n_base`` operands, then the selected rows cleared in place
    in the pool mask (operand ``pool_pos``) and the hc mask (``hc_pos``);
    the result's masks are those operands."""
    def step(*args):
        r = base(*args[:n_base])
        pool_mask = args[pool_pos]
        slots = (split_mix_index(r.indices, pool_mask.n)[1] if mix
                 else r.indices)
        clear_rows(pool_mask, r.values, slots)
        hc_mask = None
        if hc_pos is not None:
            hc_mask = clear_rows(args[hc_pos], r.values, slots)
        return FusedStepResult(r.entropy, r.values, r.indices, pool_mask,
                               hc_mask)

    return step


def shard_operand(x, mesh: Mesh, axis: int):
    """A plain tensor split on ``axis`` over the pool axis's devices
    (each process keeping its own rows); a :class:`ShardedRows` passes
    through."""
    if isinstance(x, ShardedRows):
        return x
    return multihost.feed_pool_axis(x, mesh, axis)


def make_sharded_scoring_fns(mesh: Mesh, *, k: int,
                             tie_break: str = "fast") -> dict:
    """The seven unfused scorers (``mc``, ``hc``, ``hc_pre``, ``mix``,
    ``rand``, ``qbdc``, ``wmc``) over the pool axis of ``mesh``: probs
    ``(M, N, C)`` split on N, masks and hc entropies on N, the hc table on
    rows, keys and weights replicated (``pool_mesh.PARTITION_RULES``).
    Cached per ``(mesh, k, tie_break)``; do not mutate the dict."""
    from consensus_entropy_tpu_torch.parallel import pool_mesh

    fns = pool_mesh.make_sharded_step_fns(mesh, k=k, tie_break=tie_break)
    return {key: fns[key] for key in ("mc", "hc", "hc_pre", "mix", "rand",
                                      "qbdc", "wmc")}


def make_shardmap_mc_scorer(mesh: Mesh, *, k: int):
    """The mc scorer of the JAX package's written-out ``shard_map``: per
    shard the consensus mean, masked entropy and a local top-k, then the
    candidate merge ('fast' ties: the lowest global index wins).  It is
    the sharded family's ``mc``.  ``scorer(member_probs, pool_mask) ->
    ScoreResult``; plain tensors are split over the pool axis."""
    from consensus_entropy_tpu_torch.parallel import pool_mesh

    return pool_mesh.make_sharded_step_fns(mesh, k=k)["mc"]


def make_shardmap_pallas_mc_scorer(mesh: Mesh, *, n_members: int, k: int,
                                   fuse_topk: bool = True):
    """B2: the fused softmax-linear mc scorer over a pool-sharded pool.
    Each shard runs ``linear_score_mc`` (the ``csrc/linear_mc.cu`` kernel
    on CUDA tensors, one launch a shard; its plain version on CPU tensors)
    on its song-major rows with ``k`` candidates, ranked in the kernel when
    ``fuse_topk``; the shards' candidates merge as above.

    ``scorer(x, w_packed, b_packed, pool_mask) -> ScoreResult`` for ``x``
    ``(N, K, F)`` float32 split on N (the TPU version's ``pack_pool`` tile
    layout was a Mosaic workaround and is not taken), column-packed
    weights replicated, ``pool_mask`` ``(N,)``.  'fast' ties."""
    from consensus_entropy_tpu_torch.kernels.linear_mc import linear_score_mc

    def local(x, w_packed, b_packed, mask):
        return ScoreResult(*linear_score_mc(
            x, w_packed, b_packed, mask, n_members=n_members, k=k,
            fuse_topk=fuse_topk))

    def scorer(x, w_packed, b_packed, pool_mask) -> ScoreResult:
        return sharded_select(local, (shard_operand(x, mesh, 0), w_packed,
                                      b_packed,
                                      shard_operand(pool_mask, mesh, -1)),
                              k=k)

    return scorer


def pad_pool(arrays, n_valid: int, n_pad: int, *, axis: int = 0):
    """Pad each array's pool axis from ``n_valid`` to ``n_pad`` and build
    the validity mask: ``(padded_arrays, mask)`` (host numpy, once per
    user; afterwards only the mask changes)."""
    if n_pad < n_valid:
        raise ValueError(f"pad target {n_pad} < pool size {n_valid}")
    out = []
    for a in arrays:
        a = np.asarray(a)
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n_pad - a.shape[axis])
        out.append(np.pad(a, widths))
    mask = np.zeros(n_pad, dtype=bool)
    mask[:n_valid] = True
    return out, mask
