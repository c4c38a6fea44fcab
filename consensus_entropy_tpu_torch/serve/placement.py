"""Bucket-aware cross-host placement for the elastic serve fabric.

Counterpart of ``consensus_entropy_tpu/serve/placement.py``, byte for byte
in its decisions.  Two same-bucket users split across hosts each run a
half-full stacked dispatch; co-located they run one full dispatch.  This
module is that routing policy, as pure functions of replayed journal
state:

- :func:`bucket_for` maps a user's journaled enqueue-time pool size onto
  its dispatch bucket (the fleet planner's merged edges when they exist,
  the router's power-of-two geometry otherwise: the width the worker's
  own ``BucketRouter`` pins at admission).
- :func:`place` picks the host for one admitted user: among hosts within
  ``max_skew`` of the least load, the one with the most unresolved
  same-bucket users, then least loaded, then host id.  With no pool
  information it is the least-loaded rule (the ``load`` policy).
- :func:`plan_failover` places a failed host's (or a restart's) whole
  victim set as one bucket-grouped plan.
- :func:`plan_rebalance` plans the queued-user migrations a host join
  triggers; in-flight users are never planned.

Every input is journal-replayable, so a restarted coordinator re-derives
the same decisions.
"""

from __future__ import annotations

from consensus_entropy_tpu_torch.serve.buckets import next_pow2

#: routing policy arms: ``bucket`` co-locates same-bucket users (this
#: module's reason to exist), ``load`` is the least-loaded baseline
PLACEMENT_POLICIES = ("bucket", "load")

#: how far above the least-loaded host a host may be and still win on
#: co-location — bounds the load imbalance bucket-affinity can create
DEFAULT_MAX_SKEW = 4


def bucket_for(pool_size, edges=()) -> int | None:
    """The dispatch-bucket width a pool of this size pads to: the
    smallest edge that fits, else the power-of-two fall-through — the
    ``BucketRouter.width_for`` rule, reproduced here so the coordinator
    agrees with every worker's router without holding one.  ``None``
    pool (never journaled) → ``None`` (placement then ignores buckets).
    """
    if pool_size is None:
        return None
    n = int(pool_size)
    for w in edges or ():
        if int(w) >= n:
            return int(w)
    return next_pow2(n)


def placement_view(state, unresolved, hosts, edges=()) -> tuple:
    """``(loads, buckets_by_host)`` over the live ``hosts``, from
    replayed journal state: ``loads[h]`` counts the host's unresolved
    assigned users, ``buckets_by_host[h][bucket]`` how many of them sit
    in each dispatch bucket (users with no journaled pool don't count
    toward any bucket)."""
    loads = {h: 0 for h in hosts}
    buckets: dict[str, dict] = {h: {} for h in hosts}
    for u in unresolved:
        h = state.assigned.get(u)
        if h not in loads:
            continue
        loads[h] += 1
        b = bucket_for(state.pools.get(u), edges)
        if b is not None:
            buckets[h][b] = buckets[h].get(b, 0) + 1
    return loads, buckets


def place(bucket, *, loads, buckets_by_host, policy: str = "bucket",
          max_skew: int = DEFAULT_MAX_SKEW, devices=None) -> str:
    """The host one user routes to.  Deterministic: ties break on load
    then host id, and every input is journal-replayable.

    ``devices`` (``{host: chips}``, workers advertise it in their
    heartbeats): chips-per-host heterogeneity.  Among equally
    co-located eligible hosts, prefer one whose chip count DIVIDES the
    bucket width (the pool axis shards evenly there), widest such mesh
    first — a 4-chip worker attracts the wide-pool buckets while 1-chip
    survivors keep the narrow ones.  ``None`` (or hosts missing from
    it, treated as 1 chip — 1 divides everything) reproduces the
    legacy co-location → load → id key bit-for-bit."""
    if policy not in PLACEMENT_POLICIES:
        raise ValueError(f"unknown placement policy {policy!r} "
                         f"(choose from {PLACEMENT_POLICIES})")
    if not loads:
        raise ValueError("no live hosts to place on")
    if policy == "load" or bucket is None:
        return min(loads, key=lambda h: (loads[h], h))
    floor = min(loads.values())
    eligible = [h for h in loads if loads[h] <= floor + max_skew]

    def _key(h):
        co = -buckets_by_host.get(h, {}).get(bucket, 0)
        if not devices:
            return (co, loads[h], h)
        d = int(devices.get(h) or 1)
        # divisibility first (a non-dividing mesh would be a routing
        # error at dispatch), then the widest mesh the bucket can use
        return (co, 0 if bucket % d == 0 else 1, -min(d, bucket),
                loads[h], h)

    return min(eligible, key=_key)


def place_user(user, *, state, unresolved, hosts, edges=(),
               policy: str = "bucket",
               max_skew: int = DEFAULT_MAX_SKEW, devices=None) -> str:
    """:func:`place` driven straight from replayed journal state — the
    coordinator's assignment seam."""
    loads, buckets = placement_view(state, unresolved, hosts, edges)
    return place(bucket_for(state.pools.get(str(user)), edges),
                 loads=loads, buckets_by_host=buckets, policy=policy,
                 max_skew=max_skew, devices=devices)


def plan_failover(victims, *, state, unresolved, hosts, edges=(),
                  policy: str = "bucket",
                  max_skew: int = DEFAULT_MAX_SKEW, devices=None) -> list:
    """Place a dead (or drained) host's WHOLE victim set at once:
    ``[(user, target_host), ...]`` in the given victim order (failover
    passes in-flight first, then queued — the re-admission order).

    The one-at-a-time loop this replaces called :func:`place_user` per
    victim in re-admission order, which interleaves buckets (in-flight
    users first, whatever their widths): at a ``max_skew`` boundary an
    early victim's placement could push its host out of a later
    same-bucket victim's eligible set, splitting a group that fits
    together.  Planning the set at once fixes both halves: every
    placement folds into the loads/buckets view the NEXT decision reads
    (so victims co-locate with EACH OTHER, not just with survivors),
    and decisions run bucket-GROUPED — largest victim bucket first, its
    members consecutively — so a group claims its best host before
    unrelated buckets perturb the loads.  The returned plan keeps the
    caller's victim order: re-admission order (journal/feed append
    order) is a recovery contract, only the DECISIONS are grouped.

    Same pure-function-of-journal-state discipline as
    :func:`place_user`: every input replays from the journal, so a
    restarted coordinator re-derives the identical plan."""
    loads, buckets = placement_view(state, unresolved, hosts, edges)
    by_bucket: dict = {}
    order: list = []
    for u in victims:
        b = bucket_for(state.pools.get(str(u)), edges)
        if b not in by_bucket:
            by_bucket[b] = []
            order.append(b)
        by_bucket[b].append(u)
    # largest group first (ties: first-seen), bucketless victims last —
    # a big group's co-location claim is worth the most
    seen = {b: i for i, b in enumerate(order)}
    order.sort(key=lambda b: (b is None, -len(by_bucket[b]), seen[b]))
    target_of: dict = {}
    for b in order:
        for u in by_bucket[b]:
            target = place(b, loads=loads, buckets_by_host=buckets,
                           policy=policy, max_skew=max_skew,
                           devices=devices)
            target_of[u] = target
            loads[target] += 1
            if b is not None:
                buckets[target][b] = buckets[target].get(b, 0) + 1
    return [(u, target_of[u]) for u in victims]


def plan_rebalance(new_host, *, loads, queued_by_host) -> list:
    """Migrations a JOIN triggers: ``[(user, source_host), ...]``.

    ``loads``: unresolved-user count per live host (the joiner included,
    typically 0).  ``queued_by_host``: each OTHER host's still-queued
    (never in-flight) unresolved users in journal enqueue order — the
    only users safe to move, because nothing of theirs has run yet.

    Greedy and deterministic: while the joiner sits below the fleet's
    floor share (``total // n_hosts``), take the LAST-enqueued queued
    user from the most-loaded donor still above the floor (ties on host
    id).  Late-enqueued users move because the earliest-enqueued keep
    their position at the head of their current host's queue — migration
    must never reorder who runs first."""
    loads = {h: int(n) for h, n in loads.items()}
    if new_host not in loads:
        loads[new_host] = 0
    floor = sum(loads.values()) // max(len(loads), 1)
    queues = {h: list(q) for h, q in queued_by_host.items()
              if h != new_host}
    moves: list = []
    while loads[new_host] < floor:
        donors = [h for h, q in queues.items()
                  if q and loads.get(h, 0) > floor]
        if not donors:
            break
        donor = max(donors, key=lambda h: (loads[h], h))
        user = queues[donor].pop()
        moves.append((user, donor))
        loads[donor] -= 1
        loads[new_host] += 1
    return moves
