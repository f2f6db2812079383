"""Time-quantum views as one bucketed device plane.

The counterpart of ``pilosa_tpu.timeviews``.  A time field's
finest-unit views land in ONE plane with a (row, bucket) axis: plane row
``slot_of[row_id] * n_buckets + bucket`` holds ``row_id``'s bits for
calendar bucket ``bucket`` (view suffixes sorted ascending: at a fixed
suffix length digit order is calendar order).  "Row seen in [t0, t1)"
is then an OR over one CONTIGUOUS run of plane rows
(:meth:`pilosa_tpu_torch.exec.fused.FusedCache.run_time_range`), and
time-bucketed writes absorb into the plane's delta overlay, whose cells
are keyed by that flat (row, bucket) slot.

Only the finest unit's views enter the plane: a timestamped write lands
in every granularity view (:func:`pilosa_tpu_torch.store.timeq.views_by_time`),
so the finest views alone carry every bit, and the union of the finest
buckets whose spans start in ``[floor(from), floor(to))`` equals the
mixed-granularity minimal cover (``views_by_time_range``) bit for bit.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass

import numpy as np

from pilosa_tpu_torch.engine.words import WORDS_PER_SHARD, pow2_bucket
from pilosa_tpu_torch.store import timeq
from pilosa_tpu_torch.store.view import VIEW_STANDARD

# view-name suffix length per quantum unit (standard_2017 /
# standard_201701 / standard_20170102 / standard_2017010203)
_SUFFIX_LEN = {"Y": 4, "M": 6, "D": 8, "H": 10}


def finest_unit(quantum: str) -> str:
    """The smallest granularity unit of a quantum string."""
    return timeq.validate_quantum(quantum)[-1]


def bucket_suffixes(field) -> list[str]:
    """Sorted finest-unit time-view suffixes present on ``field``: the
    plane's bucket directory."""
    n = _SUFFIX_LEN[finest_unit(field.options.time_quantum)]
    pre = VIEW_STANDARD + "_"
    out = []
    for name in list(field.views):
        suf = name[len(pre):] if name.startswith(pre) else ""
        if len(suf) == n and suf.isdigit():
            out.append(suf)
    return sorted(out)


@dataclass
class TimePlaneSet:
    """One time field's views as a single bucketed device plane.

    Like :class:`pilosa_tpu_torch.exec.planes.PlaneSet`, ``plane`` is the
    immutable base and ``delta`` an optional device write overlay, its
    cells keyed by flat (row, bucket) slot."""

    plane: object             # int32[S, RB_pad, W]; RB_pad = pow2(R * B)
    shards: tuple
    row_ids: np.ndarray       # uint64[R] sorted rows across all buckets
    slot_of: dict             # row id -> row index (slot = idx * B + b)
    buckets: tuple            # finest-unit view suffixes, ascending
    bucket_starts: tuple      # span start of each bucket (datetime)
    unit: str                 # finest quantum unit (Y/M/D/H)
    delta: object | None = None

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_range(self, start, end) -> tuple[int, int]:
        """The half-open bucket range answering ``[start, end)`` after both
        endpoints are floored to the finest unit (``None`` = unbounded):
        bucket ``b`` is in range iff ``floor(start) <= starts[b] <
        floor(end)``."""
        b0 = (0 if start is None else bisect_left(
            self.bucket_starts, timeq._floor(start, self.unit)))
        b1 = (self.n_buckets if end is None else bisect_left(
            self.bucket_starts, timeq._floor(end, self.unit)))
        return b0, max(b0, b1)


def time_gens(field, shards, fast: bool = False) -> tuple:
    """Per-bucket-view fragment generations, each tagged with its suffix:
    the time plane entry's validity snapshot.  A NEW bucket (the first
    write into a fresh calendar period) then reads as a different
    directory, not merely a bumped generation the overlay could absorb."""
    out = []
    for suf in bucket_suffixes(field):
        v = field.views.get(VIEW_STANDARD + "_" + suf)
        if v is None:
            gens = ()
        else:
            gens = (v.generations_fast(shards) if fast
                    else v.generations(shards))
        out.append((suf, gens))
    return tuple(out)


def plan_time_plane(field, shards):
    """The bucket directory, row union and padded geometry: the host-only
    half of the build, so the plane cache can hold ``nbytes`` against its
    budget before expanding any fragment.  Returns ``(buckets,
    bucket_starts, unit, row_ids, slot_of, rb_pad, nbytes)``, or None when
    the field has no time views yet."""
    buckets = tuple(bucket_suffixes(field))
    if not buckets:
        return None
    unit = finest_unit(field.options.time_quantum)
    bucket_starts = tuple(timeq.parse_view_time(s)[0] for s in buckets)
    ids = []
    for suf in buckets:
        v = field.views.get(VIEW_STANDARD + "_" + suf)
        if v is None:
            continue
        for shard in shards:
            frag = v.fragments.get(shard)
            if frag is not None:
                arr = frag.row_ids_array()
                if len(arr):
                    ids.append(np.asarray(arr, np.uint64))
    row_ids = (np.unique(np.concatenate(ids)) if ids
               else np.empty(0, np.uint64))
    slot_of = {int(r): i for i, r in enumerate(row_ids)}
    rb_pad = pow2_bucket(max(1, len(row_ids) * len(buckets)))
    nbytes = len(shards) * rb_pad * WORDS_PER_SHARD * 4
    return buckets, bucket_starts, unit, row_ids, slot_of, rb_pad, nbytes


def build_time_plane(field, shards, assemble, plan=None):
    """Materialize the bucketed time plane through ``assemble(shards,
    rb_pad, sources)`` (``PlaneCache.assemble``), one source per bucket
    view: rows absent from a bucket leave their slots all-zero.  Returns
    a :class:`TimePlaneSet`, or None when the field has no time views."""
    if plan is None:
        plan = plan_time_plane(field, shards)
    if plan is None:
        return None
    buckets, bucket_starts, unit, row_ids, slot_of, rb_pad, _ = plan
    nb = len(buckets)
    base = np.arange(len(row_ids), dtype=np.int64) * nb
    sources = [(field.views.get(VIEW_STANDARD + "_" + suf), row_ids,
                base + b) for b, suf in enumerate(buckets)]
    plane = assemble(tuple(shards), rb_pad, sources)
    return TimePlaneSet(plane, tuple(shards), row_ids, slot_of, buckets,
                        bucket_starts, unit)
