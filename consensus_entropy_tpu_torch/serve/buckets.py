"""Pool-width bucketing for admission-time padding.

Counterpart of ``consensus_entropy_tpu/serve/buckets.py`` (``:30-109``).
The fleet's cohort-wide pad makes every user's scoring inputs one shape,
so small users carry the largest user's padding for the whole run.  The
serve layer instead pins each user, at admission, to the smallest bucket
edge that fits its pool; same-bucket sessions still stack into one
dispatch per mode, and the waste is bounded by the bucket geometry.

Power-of-two edges (the default) keep each user's padding under twice its
own pool, with a number of distinct widths logarithmic in the size
spread; operators with a known size distribution pass explicit edges
(``--bucket-widths``).
"""

from __future__ import annotations

from consensus_entropy_tpu_torch.utils import round_up as _round_up

#: every bucket edge is a multiple of this, matching the acquirer's
#: ``pad_multiple`` — the realized ``Acquirer.n_pad`` then EQUALS the
#: bucket width, so dispatch grouping, the scheduler's per-width families
#: and the report's bucket labels all agree on one number
PAD_MULTIPLE = 8


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, PAD_MULTIPLE)."""
    return max(PAD_MULTIPLE, 1 << (max(int(n), 1) - 1).bit_length())


def validate_bucket_widths(widths) -> tuple[int, ...]:
    """Validate EXPLICIT operator bucket edges at configuration time
    (``ServeConfig`` construction and the CLI's ``--bucket-widths``
    parse) instead of silently repairing them at routing time.

    Each edge must be a positive int; the sequence must be strictly
    ascending (sorted AND unique) as given — an out-of-order or
    duplicated list is a typo'd geometry, and silently sorting it hides
    which per-width family the operator actually provisioned.  Two edges that
    collapse onto the same ``PAD_MULTIPLE`` multiple are rejected for
    the same reason: both would silently route to one family.  Pools
    wider than every edge remain HANDLED — they fall through to the
    power-of-two overflow (:meth:`BucketRouter.width_for`), so no edge
    list can misroute an oversized user.  Returns the validated tuple.
    """
    edges = tuple(widths)
    if not edges:
        raise ValueError("bucket widths must be a non-empty sequence of "
                         "positive ints")
    for w in edges:
        if not isinstance(w, int) or isinstance(w, bool) or w <= 0:
            raise ValueError(f"bucket widths must be positive ints, "
                             f"got {w!r} in {list(edges)!r}")
    if list(edges) != sorted(set(edges)):
        raise ValueError(f"bucket widths must be strictly ascending "
                         f"(sorted, unique), got {list(edges)!r}")
    rounded = [_round_up(w, PAD_MULTIPLE) for w in edges]
    if len(set(rounded)) != len(rounded):
        raise ValueError(
            f"bucket widths {list(edges)!r} collapse onto the same "
            f"PAD_MULTIPLE={PAD_MULTIPLE} edge(s) {sorted(set(rounded))!r}"
            " — each edge must provision a distinct per-width family")
    return edges


class BucketRouter:
    """Maps a user's pool size to its admission bucket width.

    ``widths``: explicit ascending bucket edges (each rounded up to
    ``PAD_MULTIPLE``); a pool larger than every edge falls through to the
    next power of two, so routing is total — an oversized user gets a
    private width rather than an error or a silent cohort-max fallback.
    ``None`` (default): pure power-of-two edges.
    """

    def __init__(self, widths=None):
        if widths is None:
            self.widths: tuple[int, ...] = ()
        else:
            edges = sorted({_round_up(int(w), PAD_MULTIPLE)
                            for w in widths})
            if not edges or edges[0] <= 0:
                raise ValueError(f"bucket widths must be positive ints, "
                                 f"got {widths!r}")
            self.widths = tuple(edges)

    def update(self, widths) -> None:
        """Replace the edge set IN PLACE — the SLO planner's seam
        (``serve.planner``): edges derived from the observed pool-size
        distribution take effect for future admissions, while users
        already admitted keep their pinned pad (the router is consulted
        once, at admission).  ``widths`` are planner-derived (already
        ``PAD_MULTIPLE``-rounded, ascending, unique)."""
        self.widths = tuple(int(w) for w in widths)

    def width_for(self, n_songs: int) -> int:
        """The bucket edge this pool size pads to."""
        for w in self.widths:
            if w >= n_songs:
                return w
        return next_pow2(n_songs)

    def __repr__(self) -> str:
        return (f"BucketRouter(widths={list(self.widths)})" if self.widths
                else "BucketRouter(pow2)")
