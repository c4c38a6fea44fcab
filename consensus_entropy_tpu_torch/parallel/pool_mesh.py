"""The pool-axis families the acquirer and the fleet run on a mesh.

Counterpart of ``consensus_entropy_tpu/parallel/pool_mesh.py``:

- **all six modes, fused included**: the ``*_fused`` steps clear the
  selected rows of their sharded mask operands in place, so the device
  twins of ``DevicePoolState`` stay sharded where they are and only the
  ``2·k`` selection scalars reach the host;
- **mesh × users**: :func:`sharded_fleet_fns_for_width` runs the fleet's
  stacked scorers with the trailing pool axis split, so one dispatch
  stacks a cohort AND splits every user's pool;
- **families cached per (mesh, k, tie_break[, width])**; the telemetry
  hooks keep their ``n_devices`` keys and record nothing, as the port
  compiles nothing at run time.

Which operand is split is decided by :data:`PARTITION_RULES`, matched on
the operand names of :data:`_OPERANDS` (the JAX package's table, with a
spec written as a tuple of axis names): probs ``(M, N, C)`` on N, the
pool/hc masks and hoisted hc entropies on N, the hc table on rows; keys,
weights and member masks replicate.  A plain tensor handed to a family is
split by that rule, each process keeping its own rows
(``multihost.feed_pool_axis``); a ``ShardedRows`` is taken as it lies.
The rules read from the trailing axes, so a fleet's leading user axis
stays whole.
"""

from __future__ import annotations

import functools
import re

import torch

from consensus_entropy_tpu_torch.ops import scoring
from consensus_entropy_tpu_torch.parallel import multihost, sharding
from consensus_entropy_tpu_torch.parallel.mesh import (
    POOL_AXIS,
    Mesh,
    ShardedRows,
    local_devices,
    make_pool_mesh,
)


@functools.lru_cache(maxsize=None)
def make_pool_mesh_for(n_devices: int, device: str | None = None) -> Mesh:
    """A 1-D pool mesh over the first ``n_devices`` CUDA devices, or over
    ``n_devices`` entries of the CPU with ``device="cpu"``.  Checked here,
    so a configuration error reads as one message: ``n_devices`` must be
    at least 1 and at most what the process has."""
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(
            f"pool mesh needs at least 1 device, got {n_devices}")
    if device is not None and torch.device(device).type == "cpu":
        return make_pool_mesh(["cpu"] * n_devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices > have:
        raise ValueError(
            f"pool mesh wants {n_devices} device(s) but this process has "
            f"{have} — lower --mesh or run with more cards (a mesh over "
            f"one card repeats it: make_pool_mesh(['cuda:0'] * n))")
    return make_pool_mesh(local_devices()[:n_devices])


#: operand-name regex -> the operand's spec (one axis name or ``None`` per
#: trailing axis).  First match wins; every operand name matches a row.
PARTITION_RULES = (
    (r"probs$", (None, POOL_AXIS, None)),
    (r"(pool_mask|hc_mask|hc_ent)$", (POOL_AXIS,)),
    (r"hc_freq$", (POOL_AXIS, None)),
    (r"(key|weights|member_mask)$", ()),
)


def match_partition_rules(names) -> tuple:
    """Resolve each operand name through :data:`PARTITION_RULES`."""
    specs = []
    for name in names:
        for pat, spec in PARTITION_RULES:
            if re.search(pat, name):
                specs.append(spec)
                break
        else:
            raise ValueError(f"no partition rule matches operand {name!r}")
    return tuple(specs)


#: fn key -> its positional operand names; the ``*_masked`` variants exist
#: only in the fleet families
_OPERANDS = {
    "mc": ("probs", "pool_mask"),
    "mc_masked": ("probs", "pool_mask", "member_mask"),
    "hc": ("hc_freq", "hc_mask"),
    "hc_pre": ("hc_ent", "hc_mask"),
    "mix": ("probs", "pool_mask", "hc_freq", "hc_mask"),
    "mix_masked": ("probs", "pool_mask", "hc_freq", "hc_mask",
                   "member_mask"),
    "rand": ("key", "pool_mask"),
    "qbdc": ("probs", "pool_mask"),
    "wmc": ("probs", "pool_mask", "weights"),
    "wmc_masked": ("probs", "pool_mask", "weights", "member_mask"),
    "mc_fused": ("probs", "pool_mask"),
    "qbdc_fused": ("probs", "pool_mask"),
    "wmc_fused": ("probs", "pool_mask", "weights"),
    "rand_fused": ("key", "pool_mask"),
    "hc_pre_fused": ("hc_ent", "hc_mask", "pool_mask"),
    "mix_fused": ("probs", "pool_mask", "hc_freq", "hc_mask"),
}

#: fn keys ranking the concatenated [mc; hc] row space: their entropy is
#: whole on the first device (its layout is irregular)
_MIX_KEYS = frozenset(k for k in _OPERANDS if k.startswith("mix"))


def _out_specs(key: str):
    """The result's spec tree for one fn key (single-user shapes)."""
    vec, repl = (POOL_AXIS,), ()
    ent = repl if key in _MIX_KEYS else vec
    if key.endswith("_fused"):
        hc_mask = vec if key in ("hc_pre_fused", "mix_fused") else None
        return scoring.FusedStepResult(entropy=ent, values=repl,
                                       indices=repl, pool_mask=vec,
                                       hc_mask=hc_mask)
    return scoring.ScoreResult(entropy=ent, values=repl, indices=repl)


def _split_axis(spec: tuple, ndim: int) -> int | None:
    """The axis a spec splits in an operand of ``ndim`` axes (its leading
    axes beyond the spec, a fleet's user axis, stay whole), or ``None``."""
    if POOL_AXIS not in spec:
        return None
    return ndim - len(spec) + spec.index(POOL_AXIS)


def _sharded_fn(mesh: Mesh, key: str, fns: dict, k: int, tie_break: str):
    """One family entry: operands split by the rules, the per-shard
    scorer of ``fns`` (the unsharded family), the merge, and for a fused
    key the in-place mask shrink."""
    specs = match_partition_rules(_OPERANDS[key])
    mix = _out_specs(key).entropy == ()
    base_key = key[:-len("_fused")] if key.endswith("_fused") else key
    if base_key == "rand":
        def base(key_, pool_mask):
            return sharding.sharded_rand(key_, pool_mask, k=k)
    else:
        def base(*args):
            return sharding.sharded_select(fns[base_key], args, k=k,
                                           tie_break=tie_break, mix=mix)

    if key.endswith("_fused"):
        pool_pos, hc_pos = scoring.FUSED_MASKS[key]
        run = sharding.fused_step(base, pool_pos, hc_pos,
                                  len(_OPERANDS[base_key]), mix)
    else:
        run = base

    def call(*args):
        split = []
        for a, spec in zip(args, specs):
            axis = (_split_axis(spec, a.dim())
                    if isinstance(a, torch.Tensor) else None)
            split.append(a if axis is None
                         else multihost.feed_pool_axis(a, mesh, axis))
        return run(*split)

    return call


def make_sharded_step_fns(mesh: Mesh, *, k: int,
                          tie_break: str = "fast") -> dict:
    """The single-user sharded family: the seven scorers of
    ``ops.scoring.make_scoring_fns`` and the six ``*_fused`` steps, whose
    sharded mask operands are updated in place.  Cached per ``(mesh, k,
    tie_break)``."""
    return _sharded_step_fns_cached(mesh, k, tie_break)


@functools.lru_cache(maxsize=None)
def _sharded_step_fns_cached(mesh: Mesh, k: int, tie_break: str) -> dict:
    base = scoring.make_scoring_fns(k=k, tie_break=tie_break)
    return {key: _sharded_fn(mesh, key, base, k, tie_break) for key in base}


def sharded_fleet_fns_for_width(mesh: Mesh, *, k: int,
                                tie_break: str = "fast",
                                width: int) -> dict:
    """The fleet scorers over a leading user axis with the trailing pool
    axis split on ``mesh``: stacked probs ``(U, M, N, C)`` on N, masks
    ``(U, N)`` on N, hc tables ``(U, N, C)`` on rows; keys, weights and
    member masks replicate.  The fused keys clear the stacked sharded
    masks in place.  Guarded twice: the bucket width must divide across
    the mesh, and every call's pool mask must be ``width`` wide (a
    mis-routed session fails at dispatch)."""
    if width % mesh.size:
        raise ValueError(
            f"bucket width {width} does not divide across the "
            f"{mesh.size}-device pool mesh — admission must pad buckets "
            f"to a multiple of the mesh size")
    return _sharded_fleet_fns_cached(mesh, k, tie_break, width)


@functools.lru_cache(maxsize=None)
def _sharded_fleet_fns_cached(mesh: Mesh, k: int, tie_break: str,
                              width: int) -> dict:
    base = scoring.make_fleet_scoring_fns(k=k, tie_break=tie_break)

    def guarded(fn_key, fn):
        pos = scoring._POOL_MASK_POS[fn_key]

        def call(*args):
            got = args[pos].shape[-1]
            if got != width:
                raise ValueError(
                    f"bucket routing error: {fn_key!r} mesh scorer for "
                    f"pool width {width} got inputs of width {got}")
            return fn(*args)

        return call

    return {key: guarded(key, _sharded_fn(mesh, key, base, k, tie_break))
            for key in base}


def sharded_scatter_rows(mesh: Mesh):
    """The probs scatter into the sharded persistent buffer ``(M, N, C)``
    split on N, in place: ``scatter(buf, rows, p)`` writes column ``j`` of
    ``p`` to pool row ``rows[j]`` on the shard that holds it; rows outside
    ``[0, N)`` (the staging tail's) are dropped."""
    del mesh  # the buffer carries its layout

    def scatter(buf: ShardedRows, rows, p) -> ShardedRows:
        for s, block in enumerate(buf.blocks):
            off, nb = buf.offsets[s], buf.block_len(s)
            r = torch.as_tensor(rows).to(block.device)
            mine = ((r >= off) & (r < off + nb)).nonzero().squeeze(1)
            block.index_copy_(buf.axis, r[mine] - off,
                              torch.as_tensor(p).to(
                                  block.device, block.dtype).index_select(
                                      buf.axis, mine))
        return buf

    return scatter


def sharded_probs_buffer(mesh: Mesh, m: int, n_pad: int,
                         n_classes: int) -> ShardedRows:
    """A zeroed persistent ``(M, n_pad, C)`` probs buffer split on the
    pool axis, each block allocated on its device: this process's rows
    (``multihost.host_pool_slice``) at their global offsets, the layout
    ``multihost.feed_pool_axis`` gives the masks."""
    devices = mesh.axis_devices(POOL_AXIS)
    rows = multihost.host_pool_slice(n_pad)
    local = rows.stop - rows.start
    if local % len(devices):
        raise ValueError(f"{local} rows do not divide across "
                         f"{len(devices)} shards")
    per = local // len(devices)
    return ShardedRows(
        [torch.zeros((m, per, n_classes), dtype=torch.float32, device=d)
         for d in devices], 1,
        tuple(rows.start + s * per for s in range(len(devices))), n_pad)
