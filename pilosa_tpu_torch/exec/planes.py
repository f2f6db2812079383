"""Device-resident plane cache: host fragments -> packed int32 tensors.

A (field, view) over a shard list is materialized as one
``int32[n_shards, R_pad, W]`` tensor (rows padded to a power of two, row
``row_ids[i]`` at slot ``i`` — the slot map of ``pilosa_tpu.exec.planes``),
and single rows as ``int32[n_shards, W]``.  Entries remember their source
fragments' generations.  Residency is byte-budgeted, least recently used
first out.

Writes never rewrite a resident plane in place.  A stale whole-view plane
absorbs its write gap (read from the fragments' mutation journals) into a
bounded device overlay (:mod:`pilosa_tpu_torch.ingest.delta`) and the
delta-aware families answer base+delta; past ``delta_compact_fraction``
of ``delta_cells`` a background compactor folds the overlay into a NEW
base tensor (clone, then scatter) and swaps the entry, so a reader still
holding the old ``PlaneSet`` keeps a consistent base and overlay.  A stale
single row is refreshed the same way.  A new row id, a journal gap or a
gap wider than the caps rebuilds, as in the reference.

A BSI field's plane (:meth:`PlaneCache.bsi_plane`) holds its fixed rows
(exists, sign, ``bit_depth`` magnitude bits) unpadded, keyed by the bit
depth, so a write that grows the depth builds a new plane.  Its overlay
is a :class:`~pilosa_tpu_torch.ingest.delta.BsiOverlay`, grouped by word
column.

A rows plane (:meth:`PlaneCache.rows_plane`, GroupBy's levels) holds just
the selected rows, padded to a power of two; a stale one takes the
journal cells of its own rows and skips the others.

A time field's plane (:meth:`PlaneCache.time_plane_nowait`) holds its
finest-unit views as one (row, bucket) axis
(:mod:`pilosa_tpu_torch.timeviews`).  A write into existing buckets of
existing rows absorbs into an overlay keyed by flat (row, bucket) slot; a
new bucket, a new row, a whole-row op, a journal gap or a full overlay
rebuilds it.  Time planes never fold.

The build expands fragments chunk by chunk into a pinned host staging
buffer and copies each chunk into one preallocated device tensor; two
staging buffers alternate so chunk N's expansion overlaps chunk N-1's
host-to-device copy.  A chunk's fragments expand at once on
``BUILD_WORKERS`` builder threads (each expansion is one native codec
call, which releases the interpreter lock), each into its own slab row
under its own fragment's lock.  With ``sidecars`` on (the default, as in
the reference) a fragment with a fresh ``.dense`` image is read from it
(a warm hit).  A cold expansion over the fragment's full row set writes
one in a build past ``SYNC_BUILD_MAX`` bytes and in a page-in, where the
reference writes them (its background builds and page-ins); a smaller
build expands from the snapshots and writes nothing, as the reference's
inline builds do.  The disk writes go to one writer thread through a
bounded queue, so a slow disk holds the builders back instead of
buffering images.  A plane past
``SYNC_BUILD_MAX`` asked for through :meth:`PlaneCache.field_plane_nowait`
builds on a background thread while requests stream.

A field whose dense plane exceeds the budget has three more forms: its
host row cardinalities (:func:`merge_row_cards`), a CSR residency of its
set bits (:meth:`PlaneCache.sparse_plane`, counted by
:mod:`pilosa_tpu_torch.engine.sparse`) and row blocks streamed through the
card (:meth:`PlaneCache.iter_row_blocks`); Counts over it are served in
shard pages (:mod:`pilosa_tpu_torch.tenancy.paging`).

Under a placement (:mod:`pilosa_tpu_torch.parallel.mesh`) every plane is a
:class:`~pilosa_tpu_torch.parallel.mesh.Blocked` tensor: its shard axis in
contiguous blocks, one per device.  A build expands fragments the same way
and copies each chunk into the blocks it spans, paid into the same build
metrics; padding shards (``PAD_SHARD``) have no fragment and stay zero.
Overlays split by block (each block's cells, re-indexed to it, on its
device), a fold or row refresh scatters per block, and a sparse residency
keeps one CSR triple per block with word indices local to the block's
filter words.  Planes build inline under a placement, as the reference's
meshed builds do; a time plane is blocked too, its overlay split by
block as a set plane's is.

Eviction: past the budget, entries leave in the order of the
:class:`~pilosa_tpu_torch.tenancy.governor.ResidencyGovernor`'s keep-score,
least recently used first among equals (with no telemetry, plain LRU).
Entries handed to a query between :meth:`PlaneCache.begin_query` and
:meth:`PlaneCache.end_query` are leased to it and never evicted meanwhile.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from pilosa_tpu_torch import timeviews
from pilosa_tpu_torch.engine import resolve_device
from pilosa_tpu_torch.engine.bsi import OFFSET_ROW
from pilosa_tpu_torch.engine.words import (SHARD_WIDTH, WORDS_PER_SHARD,
                                           pow2_bucket)
from pilosa_tpu_torch.ingest.delta import DeltaMirror, DeltaOverlay
from pilosa_tpu_torch.obs import NULL_FLIGHT, NopStats
from pilosa_tpu_torch.obs.ledger import set_plane_context
from pilosa_tpu_torch.parallel.mesh import PAD_SHARD, Blocked, PerBlock
from pilosa_tpu_torch.store.field import Field
from pilosa_tpu_torch.store.fragment import Fragment
from pilosa_tpu_torch.store.view import VIEW_STANDARD

DEFAULT_BUDGET = 4 << 30


def merge_row_cards(frags) -> tuple[np.ndarray, np.ndarray]:
    """Per-fragment ``(row_ids, cardinalities)`` merged across shards:
    (uint64[R] sorted ids, int64[R] summed cards), with no bit expanded."""
    id_parts, card_parts = [], []
    for frag in frags:
        ids, cards = frag.row_cardinalities()
        if len(ids):
            id_parts.append(ids)
            card_parts.append(cards)
    if not id_parts:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    ids = np.concatenate(id_parts)
    cards = np.concatenate(card_parts)
    top = int(max(p[-1] for p in id_parts))
    if top < 4 * len(ids) + (1 << 16):
        # dense ids (millions of sparse rows): one pass instead of a sort;
        # every listed row has at least one bit, so the nonzero sums are
        # the rows
        sums = np.bincount(ids.astype(np.int64), weights=cards,
                           minlength=top + 1)
        all_ids = np.flatnonzero(sums).astype(np.uint64)
        return all_ids, sums[all_ids.astype(np.int64)].astype(np.int64)
    all_ids = np.unique(ids)
    totals = np.zeros(len(all_ids), np.int64)
    np.add.at(totals, np.searchsorted(all_ids, ids), cards)
    return all_ids, totals


def plane_from_numpy(words: np.ndarray, device=None) -> torch.Tensor:
    """A uint32 host array (a plane or bitmap from ``pilosa_tpu``, or any
    packed words) as the port's int32 device tensor, bit for bit."""
    host = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(host).to(resolve_device(device), copy=True)


def _apply_plane_cells(plane: torch.Tensor, cell_rows, cell_words,
                       cell_vals, reset_rows, reset_vals) -> torch.Tensor:
    """A copy of ``plane`` with whole rows replaced, then cells overwritten
    (``pilosa_tpu.exec.planes._apply_plane_cells``).  Rows are flat indices
    into ``plane.reshape(-1, W)``; values are uint32 numpy words.  Out of
    place, like the reference's undonated scatter: a reader holding the
    old tensor (and an overlay over it) must not see the cells twice.
    Indices are checked on the host: an out-of-range index on the card
    would be a device-side assert."""
    w = plane.shape[-1]
    total = plane.numel() // w if w else 0
    cell_rows = np.asarray(cell_rows, np.int64)
    cell_words = np.asarray(cell_words, np.int64)
    reset_rows = np.asarray(reset_rows, np.int64)
    for name, idx, bound in (("cell row", cell_rows, total),
                             ("cell word", cell_words, w),
                             ("reset row", reset_rows, total)):
        if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= bound):
            raise IndexError(f"_apply_plane_cells: {name} outside "
                             f"[0, {bound})")
    if isinstance(plane, Blocked):
        return _apply_blocked_cells(plane, cell_rows, cell_words, cell_vals,
                                    reset_rows, reset_vals)
    dev = plane.device
    out = plane.clone()
    flat = out.view(-1, w)
    if len(reset_rows):
        vals = np.ascontiguousarray(reset_vals, np.uint32).reshape(-1, w)
        flat[torch.from_numpy(reset_rows).to(dev)] = \
            torch.from_numpy(vals.view(np.int32)).to(dev)
    if len(cell_rows):
        vals = np.ascontiguousarray(cell_vals, np.uint32)
        flat[torch.from_numpy(cell_rows).to(dev),
             torch.from_numpy(cell_words).to(dev)] = \
            torch.from_numpy(vals.view(np.int32)).to(dev)
    return out


def _apply_blocked_cells(plane: Blocked, cell_rows, cell_words, cell_vals,
                         reset_rows, reset_vals) -> Blocked:
    """:func:`_apply_plane_cells` per block of a blocked plane: each
    block takes the cells and rows of its shards (and words), re-indexed
    to it."""
    per = int(np.prod(plane.shape[1:-1], dtype=np.int64))  # rows a shard
    cell_vals = np.asarray(cell_vals, np.uint32)
    reset_vals = np.asarray(reset_vals, np.uint32)
    args = ([], [], [], [], [])
    for s0, s1, w0, w1 in plane.layout:
        sel = (cell_rows >= s0 * per) & (cell_rows < s1 * per)
        rsel = (reset_rows >= s0 * per) & (reset_rows < s1 * per)
        if w0 is not None:
            sel &= (cell_words >= w0) & (cell_words < w1)
        args[0].append(cell_rows[sel] - s0 * per)
        args[1].append(cell_words[sel] - (w0 or 0))
        args[2].append(cell_vals[sel])
        args[3].append(reset_rows[rsel] - s0 * per)
        args[4].append(reset_vals[rsel][:, w0:w1] if w0 is not None
                       else reset_vals[rsel])
    return plane.like(plane.map(_apply_plane_cells, plane,
                                *(PerBlock(a) for a in args)))


@dataclass
class PlaneSet:
    """One materialized (field, view): device plane + row-slot mapping.

    ``plane`` is the immutable base; ``delta``, when set, carries the
    cells written since it was built, and the delta-aware families answer
    base+delta.  Consumers that need a clean plane go through
    :meth:`PlaneCache.field_plane`, which folds first."""

    plane: torch.Tensor       # int32[n_shards, R_pad, W] (Blocked: placed)
    shards: tuple[int, ...]   # PAD_SHARD entries are zero shards
    row_ids: np.ndarray       # uint64[R] real rows (slots beyond are pad)
    slot_of: dict[int, int]
    delta: DeltaOverlay | None = None

    @property
    def n_rows(self) -> int:
        return len(self.row_ids)


@dataclass
class SparseSet:
    """One (field, view) as CSR arrays of its set bits
    (:mod:`pilosa_tpu_torch.engine.sparse`): memory grows with the bits,
    not with rows x shard width.  Bits are sorted by row; pad bits carry
    mask 0 and pad rows repeat the bit count in ``row_ptr``.  Under a
    1-D placement the three arrays are :class:`PerBlock` values, one CSR
    triple per block, word indices local to the block's filter words."""

    word_idx: torch.Tensor    # int32[N_pad] flat filter word per bit
    mask: torch.Tensor        # int32[N_pad]: the bit's uint32 lane mask
    row_ptr: torch.Tensor     # int32[R_pad + 1] row boundaries
    row_ids: np.ndarray       # uint64[R] sorted rows
    row_cards: np.ndarray     # int64[R] each row's bits
    shards: tuple[int, ...]
    nbytes: int
    n_rows_pad: int
    delta: None = None        # never carries an overlay: a write rebuilds

    @property
    def n_rows(self) -> int:
        return len(self.row_ids)


class PlaneCache:
    BUILD_CHUNK_BYTES = 256 << 20
    # past this many changed cells beyond the overlay's cap a fold (or a
    # row refresh) gives way to a rebuild
    MAX_INCR_CELLS = 4096
    # planes up to this size build on the request that asks; past it
    # field_plane_nowait builds them on a background thread
    SYNC_BUILD_MAX = 256 << 20
    # builder threads expanding one chunk's fragments
    BUILD_WORKERS = 8
    # sidecar images queued for the writer thread before builders wait
    SIDECAR_QUEUE = 8

    def __init__(self, device=None, budget_bytes: int = DEFAULT_BUDGET,
                 delta_cells: int = 65536,
                 delta_compact_fraction: float = 0.5, governor=None,
                 sidecars: bool = True, stats=None, flight=None,
                 placement=None):
        # ``placement``: the executor's mesh placement (planes built as
        # Blocked tensors over its devices), None on one device
        self.placement = placement
        self.device = (placement.first if placement is not None
                       else resolve_device(device))
        # the plane_* / delta_* metric families and the eviction events
        self._stats = stats or NopStats()
        self.flight = flight or NULL_FLIGHT
        self.budget = budget_bytes
        self.governor = governor
        self.sidecars = sidecars
        # fragment expansions served from a sidecar (warm) or expanded
        # and, over a full row set, written to one (cold); page-ins count
        self.warm_hits = 0
        self.warm_misses = 0
        self.sidecar_bytes_written = 0
        self.sidecar_write_seconds = 0.0
        self._entries: OrderedDict = OrderedDict()  # key -> (gens, ps, n)
        self._bytes = 0
        self._zeros: dict[int, torch.Tensor] = {}
        self._bytes_cache: dict = {}
        self._lock = threading.RLock()
        self._build_lock = threading.Lock()
        self.builds = 0
        self.last_build_seconds = 0.0
        self.last_build_bytes = 0
        self.build_seconds_total = 0.0
        self.build_bytes_total = 0
        self.build_failures = 0
        self._failed_logged: set = set()
        self._building: dict = {}  # key -> background builder thread
        # view paths each running assemble reads, by a token of the call
        self._assembling: dict[int, tuple] = {}
        self._assembled = threading.Condition(self._lock)
        # entries leased to each thread's query (never evicted meanwhile)
        self._leases: dict[int, set] = {}
        self.evictions = 0
        self._evictions_by_reason: dict[str, int] = {}
        # plane requests answered by a resident entry / built first
        self.hits = 0
        self.misses = 0
        # delta overlays: key -> (base plane tensor, DeltaMirror); a
        # rebuilt or folded base invalidates its mirror by identity
        self.delta_cells = int(delta_cells)
        self.delta_compact_fraction = float(delta_compact_fraction)
        self._delta_mirrors: dict = {}
        self._compacting: dict = {}  # key -> compactor thread
        self.delta_absorbs = 0
        self.delta_compactions = 0
        self.last_compaction_seconds = 0.0
        self.incremental_applied = 0  # folds and row refreshes

    # -- public -------------------------------------------------------------

    def field_plane(self, index: str, field: Field, view_name: str,
                    shards: tuple[int, ...]) -> PlaneSet:
        """Clean whole-view plane: a stale or overlay-carrying entry folds
        first; built synchronously when absent or not foldable."""
        key = ("plane", index, field.name, view_name, shards)
        return self._get(key, field, view_name, shards, self._build_plane)

    def field_plane_nowait(self, index: str, field: Field, view_name: str,
                           shards: tuple[int, ...]) -> PlaneSet | None:
        """The whole-view plane for the delta-aware families, or None while
        it is not resident: a fresh entry serves as it is, a stale one
        absorbs or folds its write gap; an absent plane (or one the journal
        cannot bring up to date) of at most ``SYNC_BUILD_MAX`` bytes builds
        here, a larger one on a background thread (one per key) while the
        caller serves another way.  None too when the plane exceeds the
        budget."""
        key = ("plane", index, field.name, view_name, shards)
        set_plane_context(f"{index}/{field.name}")
        gens = self._gens(field, view_name, shards)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == gens:
                self.hits += 1
                self._touch(key)
                self._lease(key)
                return hit[1]
            if key in self._building:
                return None
        if hit is not None:
            ps = self._delta_update(key, field, view_name, shards, hit)
            if ps is not None:
                self._lease(key)
                return ps
            del hit
        est = self.plane_bytes(field, view_name, shards)
        if est > self.budget:
            return None
        if est <= self.SYNC_BUILD_MAX or self.placement is not None:
            return self.field_plane(index, field, view_name, shards)
        with self._lock:
            if key in self._building:
                return None
            t = threading.Thread(target=self._background_build,
                                 args=(key, field, view_name, shards, gens),
                                 name="plane-build", daemon=True)
            self._building[key] = t
        t.start()
        return None

    def _background_build(self, key, field: Field, view_name: str,
                          shards: tuple[int, ...], gens) -> None:
        """Build a plane off the request path and publish it at the
        generations read before the build (a write meanwhile leaves it
        stale, and the next request absorbs the gap).  ``assemble`` waits
        on the host for every copy it issued, so a reader on any stream
        sees the whole plane.  A failure is counted and logged once per
        key; requests keep streaming and the next one retries."""
        try:
            ps = self._build_plane(field, view_name, shards)
            # published before _building is cleared: wait_builds() never
            # returns with a plane about to appear
            self._insert_entry(key, gens, ps, ps.plane.numel() * 4, field)
        except Exception:  # noqa: BLE001 — a failed build is not a failed request
            self._stats.count("plane_build_failures_total", 1)
            with self._lock:
                self.build_failures += 1
                first = key not in self._failed_logged
                if first:
                    if len(self._failed_logged) > 64:
                        self._failed_logged.clear()
                    self._failed_logged.add(key)
            if first:
                logging.getLogger("pilosa_tpu_torch.exec").exception(
                    "background plane build failed for %s (requests keep "
                    "streaming; the next one retries)", key)
        finally:
            with self._lock:
                self._building.pop(key, None)

    def wait_builds(self, timeout: float = 300.0) -> None:
        """Join the background plane builds in flight."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                t = next(iter(self._building.values()), None)
            if t is None:
                return
            t.join(max(0.1, end - time.monotonic()))

    @staticmethod
    def _bsi_key(index: str, field: Field, shards: tuple[int, ...]):
        return ("bsi", index, field.name, field.bsi_view_name, shards,
                field.options.bit_depth)

    def bsi_plane(self, index: str, field: Field,
                  shards: tuple[int, ...]) -> PlaneSet:
        """A BSI field's clean bit plane int32[S, depth + 2, W]: a pending
        overlay or a write gap folds first."""
        return self._get(self._bsi_key(index, field, shards), field,
                         field.bsi_view_name, shards, self._build_bsi)

    def bsi_plane_delta(self, index: str, field: Field,
                        shards: tuple[int, ...]) -> PlaneSet:
        """A BSI field's bit plane for the delta-aware aggregates (Sum,
        Min, Max, range Counts): a stale entry absorbs its write gap into
        a :class:`BsiOverlay` carried as ``.delta``, else folds; an absent
        one, or a gap the journal cannot cover, builds."""
        return self._delta_fetch(self._bsi_key(index, field, shards), field,
                                 field.bsi_view_name, shards,
                                 self._build_bsi)

    def rows_plane(self, index: str, field: Field, view_name: str,
                   row_ids: np.ndarray,
                   shards: tuple[int, ...]) -> PlaneSet:
        """A plane over exactly ``row_ids`` (GroupBy: memory bounded by the
        selection, not by the field's rows), padded to a power of two; a
        stale one takes its own rows' journal cells
        (:meth:`_incremental`)."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        key = ("rows", index, field.name, view_name,
               tuple(int(r) for r in row_ids), shards)
        return self._get(key, field, view_name, shards,
                         lambda f, v, s: self._build_plane(
                             f, v, s, row_ids, pow2_bucket(len(row_ids))))

    def row_words(self, index: str, field: Field, view_name: str,
                  row_id: int, shards: tuple[int, ...]) -> torch.Tensor:
        """One row across shards: int32[n_shards, W]."""
        key = ("row", index, field.name, view_name, row_id, shards)
        return self._get(key, field, view_name, shards,
                         lambda f, v, s: self._build_row(f, v, s, row_id)
                         ).plane

    # -- past the budget ----------------------------------------------------

    def sparse_bytes(self, field: Field, view_name: str,
                     shards: tuple[int, ...]) -> int:
        """The sparse residency's footprint with the padding its build
        applies (so the budget never admits a set the cache then refuses):
        8 bytes per pow2-padded bit, 4 per pow2-padded row plus one, the
        rows counted per fragment as the reference counts them.  Under a
        placement every block pads to the largest block's bucket and holds
        its own row boundaries."""
        view = field.view(view_name)
        d = self._sparse_blocks()
        per_block = np.zeros(d, np.int64)
        total_rows = 0
        if view is not None:
            spb = max(1, len(shards) // d)
            for si, s in enumerate(shards):
                frag = view.fragment(s)
                if frag is not None:
                    ids, cards = frag.row_cardinalities()
                    per_block[min(si // spb, d - 1)] += int(cards.sum())
                    total_rows += len(ids)
        return d * (pow2_bucket(int(per_block.max())) * 8
                    + (pow2_bucket(total_rows) + 1) * 4)

    def _sparse_blocks(self) -> int:
        """Blocks of the sparse residency: the shard-axis width of a 1-D
        placement; one (the flat form on the first device) otherwise, as
        the reference keeps a 2-D placement's sparse arrays flat."""
        p = self.placement
        if p is not None and p.words_size == 1:
            return p.n_devices
        return 1

    def sparse_plane(self, index: str, field: Field, view_name: str,
                     shards: tuple[int, ...]) -> SparseSet:
        """A view's CSR residency (cached and invalidated like a plane; a
        stale one rebuilds from the fragments)."""
        key = ("sparse", index, field.name, view_name, shards)
        return self._get(key, field, view_name, shards, self._build_sparse)

    def _build_sparse(self, field: Field, view_name: str,
                      shards: tuple[int, ...]) -> SparseSet:
        view = field.view(view_name)
        d = self._sparse_blocks()
        spb = len(shards) // d  # shard lists are padded to the blocks
        per_shard, frags = [], []
        if view is not None:
            for si, s in enumerate(shards):
                frag = view.fragment(s)
                if frag is not None:
                    frags.append(frag)
                    per_shard.append((si, frag.positions()))
        all_ids, row_cards = merge_row_cards(frags)
        r_pad = pow2_bucket(len(all_ids))
        parts = [([], [], []) for _ in range(d)]
        for si, pos in per_shard:
            if not len(pos):
                continue
            wi_parts, mask_parts, slot_parts = parts[si // spb]
            cols = (pos % np.uint64(SHARD_WIDTH)).astype(np.int64)
            wi_parts.append(((si % spb) * WORDS_PER_SHARD + (cols >> 5))
                            .astype(np.int32))
            mask_parts.append(np.uint32(1) << (cols & 31).astype(np.uint32))
            slot_parts.append(np.searchsorted(
                all_ids, pos // np.uint64(SHARD_WIDTH)).astype(np.int32))
        blocks = []
        for wi_parts, mask_parts, slot_parts in parts:
            if wi_parts:
                sl = np.concatenate(slot_parts)
                order = np.argsort(sl, kind="stable")  # CSR row order
                blocks.append((np.concatenate(wi_parts)[order],
                               np.concatenate(mask_parts)[order], sl[order]))
            else:
                blocks.append((np.empty(0, np.int32), np.empty(0, np.uint32),
                               np.empty(0, np.int32)))
        n_pad = pow2_bucket(max(len(b[0]) for b in blocks))
        devices = self.placement.devices if d > 1 else [self.device]
        arrays = ([], [], [])
        for (wi, mk, sl), dev in zip(blocks, devices):
            wi_out = np.zeros(n_pad, np.int32)
            mk_out = np.zeros(n_pad, np.uint32)   # mask 0 = padding
            wi_out[:len(wi)] = wi
            mk_out[:len(mk)] = mk
            # row boundaries; pad rows are empty segments at N
            rp = np.searchsorted(sl, np.arange(r_pad + 1, dtype=np.int64)
                                 ).astype(np.int32)
            for out, host in zip(arrays, (wi_out, mk_out.view(np.int32), rp)):
                out.append(torch.from_numpy(host).to(dev))
        if d > 1:
            word_idx, mask, row_ptr = (PerBlock(a) for a in arrays)
        else:
            word_idx, mask, row_ptr = (a[0] for a in arrays)
        return SparseSet(
            word_idx=word_idx, mask=mask, row_ptr=row_ptr,
            row_ids=all_ids, row_cards=row_cards, shards=shards,
            nbytes=d * (n_pad * 8 + (r_pad + 1) * 4), n_rows_pad=r_pad)

    def iter_row_blocks(self, field: Field, view_name: str,
                        shards: tuple[int, ...], block_rows: int):
        """Stream a view's rows through the card in blocks: yields
        ``(row_ids, int32[n_shards, block_rows, W])``, the last block
        zero-padded (its pad rows count 0; callers slice)."""
        view = field.view(view_name)
        row_ids = union_row_ids(field, view_name, shards)
        for start in range(0, len(row_ids), block_rows):
            chunk = row_ids[start:start + block_rows]
            yield chunk, self.assemble(
                shards, block_rows,
                [(view, chunk, np.arange(len(chunk)))], tally=False,
                warm_tally=False)

    def build_rows_plane(self, field: Field, view_name: str,
                         shards: tuple[int, ...], row_ids: np.ndarray,
                         r_pad: int, tally: bool = True,
                         sidecar_write: bool | None = None) -> PlaneSet:
        """A new plane of ``row_ids`` at slots 0.. of ``r_pad`` rows over
        ``shards`` (``tally=False``: a page-in, not a plane build)."""
        slot_of = {int(r): i for i, r in enumerate(row_ids)}
        full = self.assemble(shards, r_pad,
                             [(field.view(view_name), row_ids,
                               np.arange(len(row_ids)))], tally=tally,
                             sidecar_write=sidecar_write)
        return PlaneSet(full, shards, row_ids, slot_of)

    # -- leases and eviction ------------------------------------------------

    def begin_query(self) -> None:
        """Open this thread's lease set: entries handed out until
        :meth:`end_query` are not evicted meanwhile."""
        with self._lock:
            self._leases[threading.get_ident()] = set()

    def end_query(self) -> None:
        with self._lock:
            self._leases.pop(threading.get_ident(), None)

    def _lease(self, key) -> None:
        with self._lock:
            lease = self._leases.get(threading.get_ident())
            if lease is not None:
                lease.add(key)

    def _pinned(self) -> set:
        # caller holds self._lock
        if not self._leases:
            return set()
        return set().union(*self._leases.values())

    def _touch(self, key) -> None:
        """A served hit: most recently used, and a hit for the governor.
        Caller holds self._lock."""
        self._entries.move_to_end(key)
        if self.governor is not None:
            self.governor.note_hit(key)

    def _eviction_order(self, pinned: set, keys=None) -> list:
        """Unleased keys, first to evict first: the governor's keep-score
        ascending, least recently used first among equals (the whole order
        without a governor or telemetry).  Caller holds self._lock."""
        rank = {k: i for i, k in enumerate(self._entries)}
        ks = [k for k in (self._entries if keys is None else keys)
              if k not in pinned and k in rank]
        g = self.governor
        if g is None:
            return sorted(ks, key=rank.__getitem__)
        return sorted(ks, key=lambda k: (g.keep_score(
            k, self._entries[k][2]), rank[k]))

    def _evict_entry(self, key, reason: str) -> int:
        """Drop one entry as an eviction (caller holds self._lock and has
        checked leases); returns the bytes freed."""
        nbytes = self._entries.pop(key)[2]
        self._delta_mirrors.pop(key, None)
        self._bytes -= nbytes
        self.evictions += 1
        self._evictions_by_reason[reason] = \
            self._evictions_by_reason.get(reason, 0) + 1
        self._stats.count("plane_evictions_total", 1, reason=reason)
        self.flight.record("evict", f"{key[1]}/{key[2]}", reason,
                           float(nbytes))
        if self.governor is not None:
            self.governor.note_evict(key)
        return nbytes

    def evict_unpinned(self, target_bytes: int | None = None,
                       reason: str = "oom") -> int:
        """Evict unleased entries in eviction order until ``target_bytes``
        are freed (None: all of them); returns the bytes freed."""
        with self._lock:
            self._bytes_cache.clear()
            freed = 0
            for key in self._eviction_order(self._pinned()):
                if target_bytes is not None and freed >= target_bytes:
                    break
                freed += self._evict_entry(key, reason)
            return freed

    def invalidate(self, index: str | None = None) -> None:
        """Drop every entry, leased or not, with its overlay (the
        device-OOM recovery's last stage, run once the other queries have
        drained), or every entry of one index, whose field was deleted
        (as the reference's, even for one field).  Footprint estimates
        drop wholesale either way: an index or field recreated at the
        same path restarts its generations, which an old estimate could
        match."""
        with self._lock:
            self._bytes_cache.clear()
            for key in list(self._entries):
                if index is None or key[1] == index:
                    self._drop(key)
            if index is not None and self.governor is not None:
                self.governor.forget(index)

    def wait_idle(self, index: str, path: str,
                  timeout: float = 300.0) -> bool:
        """Wait until no background build or compaction of ``index``
        runs and no plane build reads fragments under ``path`` (a
        directory about to be removed): afterwards nothing of theirs
        writes a ``.dense`` image there.  False on timeout."""
        prefix = os.path.join(path, "")
        end = time.monotonic() + timeout
        while True:
            with self._lock:
                threads = [t for k, t in list(self._building.items())
                           + list(self._compacting.items())
                           if k[1] == index]
                busy = any(p.startswith(prefix)
                           for paths in self._assembling.values()
                           for p in paths)
            if not threads and not busy:
                return True
            left = end - time.monotonic()
            if left <= 0:
                return False
            for t in threads:
                t.join(max(0.0, min(left, 0.05)))
            if not threads:
                with self._assembled:
                    self._assembled.wait(min(left, 0.05))

    def evict_tenant(self, index: str, need_bytes: int,
                     reason: str = "quota") -> int:
        """Free up to ``need_bytes`` of one tenant's unleased entries, in
        eviction order; returns the bytes freed."""
        with self._lock:
            keys = [k for k in self._entries if k[1] == index]
            freed = 0
            for key in self._eviction_order(self._pinned(), keys):
                if freed >= need_bytes:
                    break
                freed += self._evict_entry(key, reason)
            return freed

    def tenant_bytes(self, index: str) -> int:
        """Resident bytes of one tenant (every key holds its index at
        position 1)."""
        with self._lock:
            return sum(v[2] for k, v in self._entries.items()
                       if k[1] == index)

    def has_plane(self, index: str, field: Field, view_name: str,
                  shards: tuple[int, ...]) -> bool:
        """A whole-view plane entry can serve: fresh, or stale but
        absorbable while overlays are on (the delta-aware fetch brings it
        up to date without a rebuild, or rebuilds past the journal)."""
        hit = self._entries.get(("plane", index, field.name, view_name,
                                 shards))
        if hit is None:
            return False
        return (hit[0] == self._gens(field, view_name, shards)
                or self.delta_cells > 0)

    def has_entry(self, index: str, field: Field, view_name: str,
                  shards: tuple[int, ...]) -> bool:
        """A whole-view plane entry exists, fresh or stale."""
        return ("plane", index, field.name, view_name,
                shards) in self._entries

    def plane_bytes(self, field: Field, view_name: str,
                    shards: tuple[int, ...]) -> int:
        """Dense-plane footprint estimate for budget decisions, cached
        per generation."""
        gens = self._gens(field, view_name, shards)
        key = (field.path, view_name, shards)
        with self._lock:
            hit = self._bytes_cache.get(key)
            if hit is not None and hit[0] == gens:
                return hit[1]
        est = (len(shards)
               * pow2_bucket(len(union_row_ids(field, view_name, shards)))
               * WORDS_PER_SHARD * 4)
        with self._lock:
            if field.deleted:
                return est  # a recreated field could match its stamp
            self._bytes_cache[key] = (gens, est)
            while len(self._bytes_cache) > 256:
                self._bytes_cache.pop(next(iter(self._bytes_cache)))
        return est

    def zeros(self, n_shards: int) -> torch.Tensor:
        """Cached all-zero bitmap int32[n_shards, W] (blocked under a
        placement)."""
        with self._lock:
            z = self._zeros.get(n_shards)
            if z is None:
                shape = (n_shards, WORDS_PER_SHARD)
                z = self._zeros[n_shards] = (
                    self.placement.zeros(shape) if self.placement is not None
                    else torch.zeros(shape, dtype=torch.int32,
                                     device=self.device))
            return z

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self.hits, self.misses
            return {"bytes": self._bytes, "budgetBytes": self.budget,
                    "entries": len(self._entries),
                    "pinnedEntries": len(self._pinned()),
                    "leases": len(self._leases),
                    "hits": hits, "misses": misses,
                    "hitRatio": (round(hits / (hits + misses), 4)
                                 if hits + misses else 0.0),
                    "incrementalRefreshes": self.incremental_applied,
                    "builds": self.builds,
                    "lastBuildSeconds": self.last_build_seconds,
                    "lastBuildBytes": self.last_build_bytes,
                    "buildSeconds": round(self.build_seconds_total, 3),
                    "buildBytes": self.build_bytes_total,
                    "buildFailures": self.build_failures,
                    "warmHits": self.warm_hits,
                    "warmMisses": self.warm_misses,
                    "sidecarBytesWritten": self.sidecar_bytes_written,
                    "meshed": self.placement is not None,
                    "building": len(self._building),
                    "evictions": self.evictions,
                    "evictionsByReason": dict(self._evictions_by_reason)}

    def delta_stats(self) -> dict:
        """The overlay half of the ``/status`` ingest block."""
        with self._lock:
            cells = sum(len(m) for _, m in self._delta_mirrors.values())
            bits = sum(m.bits for _, m in self._delta_mirrors.values())
            pending = len(self._compacting)
            cap = max(1, self.delta_cells)
            return {"deltaCells": cells, "deltaCap": self.delta_cells,
                    "deltaOverlayBits": bits,
                    "deltaFillRatio": (round(cells / cap, 4)
                                       if self.delta_cells else 0.0),
                    "absorbs": self.delta_absorbs,
                    "compactions": self.delta_compactions,
                    "pendingCompactions": pending,
                    "lastCompactionSeconds": round(
                        self.last_compaction_seconds, 6)}

    def mesh_stats(self) -> dict | None:
        """The ``/status`` ``mesh`` block: device count, shard axis,
        resident plane bytes per device (blocks on one device add into its
        entry) and padding shards across the entries; None without a
        placement.  Refreshes the ``plane_shard_bytes{device}`` gauges."""
        p = self.placement
        if p is None:
            return None
        with self._lock:
            entries = [e[1] for e in self._entries.values()]
        per_dev: dict[str, int] = {}
        padded = 0
        seen = set()
        for ps in entries:
            padded += sum(1 for s in getattr(ps, "shards", ())
                          if s == PAD_SHARD)
            plane = getattr(ps, "plane", None)
            if not isinstance(plane, Blocked) or id(plane) in seen:
                continue
            seen.add(id(plane))
            for d, b in _bytes_by_device(plane).items():
                per_dev[d] = per_dev.get(d, 0) + b
        for d, b in per_dev.items():
            self._stats.gauge("plane_shard_bytes", b, device=d)
        return {"devices": p.n_devices * p.words_size, "axis": p.axis,
                "perDeviceBytes": per_dev, "paddedShards": padded}

    # -- time planes --------------------------------------------------------

    def time_plane_nowait(self, index: str, field: Field,
                          shards: tuple[int, ...]):
        """One time field's bucketed plane
        (:class:`~pilosa_tpu_torch.timeviews.TimePlaneSet`), overlay and
        all, or None when the field has no time views or the plane would
        exceed the budget (the caller then unions the cover views' rows).
        Valid while its suffix-tagged bucket generations
        (``timeviews.time_gens``) match: a stale entry absorbs its write
        gap into its overlay, else it rebuilds, synchronously and one
        build at a time (the reference's entry point of this name builds
        synchronously too)."""
        key = ("tplane", index, field.name, shards)
        set_plane_context(f"{index}/{field.name}")
        hit = self._entries.get(key)
        if hit is not None and hit[0] == timeviews.time_gens(
                field, shards, fast=True):
            with self._lock:
                if key in self._entries:
                    self._touch(key)
                    self._lease(key)
            return hit[1]
        gens = timeviews.time_gens(field, shards)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == gens:
                self._touch(key)
                self._lease(key)
                return hit[1]
        if hit is not None:
            tps = self._time_absorb(key, field, shards, hit)
            if tps is not None:
                self._lease(key)
                return tps
            del hit
        with self._build_lock:
            gens = timeviews.time_gens(field, shards)
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None and hit[0] == gens:
                    return hit[1]
                if hit is not None:
                    # stale: release its device memory before rebuilding
                    self._drop(key)
                    del hit
            plan = timeviews.plan_time_plane(field, shards)
            if plan is None or plan[-1] > self.budget:
                return None
            tps = timeviews.build_time_plane(field, shards, self.assemble,
                                             plan=plan)
            self._stats.gauge("time_view_buckets", float(len(plan[0])))
            self._insert_entry(key, gens, tps, plan[-1], field, lease=True)
        return tps

    def _time_absorb(self, key, field: Field, shards: tuple[int, ...], hit,
                     attempts: int = 3):
        """Absorb a stale time plane's write gap into its overlay (cells
        keyed by flat (row, bucket) slot) and move its generations
        forward.  None = rebuild (overlays off, a new bucket or row, a
        whole-row op, a journal gap, a full overlay).  A race lost to a
        concurrent absorb retries against the new entry."""
        if self.delta_cells <= 0:
            return None
        while True:
            old_gens, tps, nbytes = hit
            got = self._time_collect_changes(field, shards, hit,
                                             self.delta_cells)
            if got is None:
                return None
            cells, actual = got
            with self._lock:
                cur = self._entries.get(key)
                if cur is None or cur[1] is not tps:
                    if cur is not None and cur[0] == actual:
                        return cur[1]  # a raced absorb got there first
                    if cur is None or attempts <= 0:
                        return None
                    attempts -= 1
                    hit = cur
                    continue
                if actual == tuple(old_gens):
                    return tps
                mir = self._delta_mirrors.get(key)
                if mir is None or mir[0] is not tps.plane:
                    mir = (tps.plane, DeltaMirror(self.delta_cells))
                    self._delta_mirrors[key] = mir
                mirror = mir[1]
                if not mirror.would_fit(cells):
                    return None  # overlay full: the rebuild supersedes it
                mirror.absorb(cells)
                overlay = self._overlay(mirror, tps.plane, bsi=False)
                new_tps = timeviews.TimePlaneSet(
                    tps.plane, tps.shards, tps.row_ids, tps.slot_of,
                    tps.buckets, tps.bucket_starts, tps.unit, delta=overlay)
                self._entries[key] = (actual, new_tps, nbytes)
                self._entries.move_to_end(key)
                self.delta_absorbs += 1
            return new_tps

    @staticmethod
    def _time_collect_changes(field: Field, shards: tuple[int, ...], hit,
                              cap: int):
        """A time plane's write gap across its bucket views as overwrite
        cells ``({(flat_row, word): current word}, covered suffix-tagged
        generations)``; None = rebuild (the bucket directory changed, a
        new fragment or row, a whole-row op, a journal gap, over ``cap``
        cells)."""
        old_gens, tps, _ = hit
        if (tuple(timeviews.bucket_suffixes(field)) != tps.buckets
                or tuple(s for s, _ in old_gens) != tps.buckets):
            return None  # a bucket appeared or vanished
        rb_pad = tps.plane.shape[1]
        nb = tps.n_buckets
        cells: dict = {}
        actual = []
        for bi, (suf, gens) in enumerate(old_gens):
            view = field.views.get(VIEW_STANDARD + "_" + suf)
            if view is None or len(gens) != len(shards):
                return None
            new_gens = list(gens)
            for si, s in enumerate(shards):
                frag = view.fragment(s)
                if frag is None:
                    if gens[si] != -1:
                        return None  # fragment vanished
                    continue
                with frag.lock:
                    if gens[si] == -1:
                        return None  # new fragment: its rows are unknown
                    if frag.generation == gens[si]:
                        continue
                    changed = frag.changed_cells_since(gens[si])
                    if changed is None:
                        return None
                    for r, words in changed.items():
                        slot = tps.slot_of.get(int(r))
                        if slot is None or words is None:
                            return None  # a new row, or a whole-row op
                        flat = si * rb_pad + slot * nb + bi
                        w_arr = np.fromiter(words, np.int64, len(words))
                        vals = frag.row_words(int(r), w_arr)
                        cells.update(zip(((flat, w) for w in w_arr.tolist()),
                                         vals.tolist()))
                        if len(cells) > cap:
                            return None
                    new_gens[si] = frag.generation
            actual.append((suf, tuple(new_gens)))
        return cells, tuple(actual)

    def time_plane_status(self) -> list[dict]:
        """Resident time planes for the ``/status`` ``timeViews`` block:
        bucket, row and byte geometry and overlay state per field, and
        under a placement the plane's bytes per device."""
        with self._lock:
            entries = list(self._entries.items())
        out = []
        for key, (_, tps, nbytes) in entries:
            if key[0] != "tplane":
                continue
            row = {"index": key[1], "field": key[2], "shards": len(key[3]),
                   "buckets": int(tps.n_buckets), "unit": tps.unit,
                   "rows": int(len(tps.row_ids)), "bytes": int(nbytes),
                   "delta": tps.delta is not None}
            if isinstance(tps.plane, Blocked):
                row["perDeviceBytes"] = _bytes_by_device(tps.plane)
            out.append(row)
        return out

    def wait_compactions(self, timeout: float | None = None) -> bool:
        """Join the background compactors; True when none is running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                threads = list(self._compacting.values())
            if not threads:
                return True
            for t in threads:
                t.join(None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            if deadline is not None and time.monotonic() >= deadline:
                with self._lock:
                    return not self._compacting

    # -- internal -----------------------------------------------------------

    @staticmethod
    def _gens(field: Field, view_name: str, shards: tuple[int, ...]) -> tuple:
        view = field.view(view_name)
        return () if view is None else view.generations(shards)

    def _delta_fetch(self, key, field: Field, view_name: str,
                     shards: tuple[int, ...], build) -> PlaneSet:
        """A fresh entry as it is, overlay and all; a stale one brought up
        to date by :meth:`_delta_update`; else :meth:`_get`."""
        set_plane_context(f"{key[1]}/{key[2]}")
        gens = self._gens(field, view_name, shards)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == gens:
                self._touch(key)
                self._lease(key)
                return hit[1]
        if hit is not None:
            ps = self._delta_update(key, field, view_name, shards, hit)
            if ps is not None:
                self._lease(key)
                return ps
        return self._get(key, field, view_name, shards, build)

    def _get(self, key, field: Field, view_name: str,
             shards: tuple[int, ...], build) -> PlaneSet:
        """A clean entry for ``key``: fresh ones serve as they are; a
        stale or overlay-carrying plane folds, a stale row refreshes;
        otherwise (or when the journal cannot cover the gap) it builds."""
        # the cost ledger's plane: one thread-local write
        set_plane_context(f"{key[1]}/{key[2]}")
        gens = self._gens(field, view_name, shards)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == gens and hit[1].delta is None:
                self.hits += 1
                self._touch(key)
                self._lease(key)
                return hit[1]
        if hit is not None and key[0] != "sparse":
            # a sparse residency takes no overlay: stale, it rebuilds
            refresh = (self._incremental if key[0] in ("row", "rows")
                       else self._fold)
            ps = refresh(key, field, view_name, shards, hit)
            if ps is not None:
                self._lease(key)
                return ps
        with self._build_lock:
            with self._lock:
                hit = self._entries.get(key)
                if (hit is not None and hit[0] == gens
                        and hit[1].delta is None):
                    self._lease(key)
                    return hit[1]
                if hit is not None:
                    # stale: release its device memory before rebuilding
                    self._drop(key)
                    del hit
                self.misses += 1
            ps = build(field, view_name, shards)
            nbytes = getattr(ps, "nbytes", None)
            self._insert_entry(key, gens, ps, ps.plane.numel() * 4
                               if nbytes is None else nbytes, field,
                               lease=True)
        return ps

    def _drop(self, key) -> None:
        # caller holds self._lock
        self._bytes -= self._entries.pop(key)[2]
        self._delta_mirrors.pop(key, None)

    def _insert_entry(self, key, gens, ps, nbytes: int,
                      field: Field | None = None,
                      lease: bool = False) -> None:
        """Cache a built plane (leased to the calling query when ``lease``)
        and evict other unleased entries in eviction order down to the
        budget.  A rebuilt base supersedes any pending overlay: the build
        re-read every fragment, so the mirror's cells are already in it.
        A plane of a field deleted meanwhile is not cached: a field
        recreated at the same path restarts its generations, which the
        stale plane's could match (the deletion sets ``field.deleted``
        before it takes this lock to invalidate)."""
        with self._lock:
            if field is not None and field.deleted:
                return
            if key in self._entries:
                self._drop(key)
            self._delta_mirrors.pop(key, None)
            if nbytes > self.budget:
                return  # served this once, never resident
            self._entries[key] = (gens, ps, nbytes)
            self._bytes += nbytes
            if lease:
                self._lease(key)
            if self._bytes > self.budget and len(self._entries) > 1:
                for k in self._eviction_order(self._pinned()):
                    if (self._bytes <= self.budget
                            or len(self._entries) <= 1):
                        break
                    if k != key:
                        self._evict_entry(k, "budget")

    def _swap(self, key, ps: PlaneSet, gens, new_ps: PlaneSet) -> bool:
        """Replace the entry serving ``ps`` by ``new_ps`` at ``gens``;
        False when another absorb, fold or build replaced it first."""
        with self._lock:
            cur = self._entries.get(key)
            if cur is None or cur[1] is not ps:
                return False
            self._entries[key] = (tuple(gens), new_ps, cur[2])
            self._entries.move_to_end(key)
            return True

    # -- write gaps ---------------------------------------------------------

    def _collect_changes(self, field: Field, view_name: str,
                         shards: tuple[int, ...], hit, cap: int):
        """The write gap between a "plane" entry's generations and the
        fragments as overwrite cells: ``({(flat_row, word): current word},
        [(flat_row, row words)] whole-row resets, covered generations)``,
        or None when the journal cannot cover it (gap, new row, over
        ``cap`` cells; a reset counts 64)."""
        old_gens, ps, _ = hit
        view = field.view(view_name)
        if view is None or len(old_gens) != len(shards):
            return None
        r_pad = ps.plane.shape[1]
        cells: dict = {}
        resets: list = []
        actual = list(old_gens)
        for si, s in enumerate(shards):
            frag = view.fragment(s)
            if frag is None:
                if old_gens[si] != -1:
                    return None  # fragment vanished
                continue
            with frag.lock:
                if old_gens[si] == -1:
                    return None  # new fragment: row set unknown
                if frag.generation == old_gens[si]:
                    continue
                changed = frag.changed_cells_since(old_gens[si])
                if changed is None:
                    return None
                for r, words in changed.items():
                    slot = ps.slot_of.get(int(r))
                    if slot is None:
                        return None  # new row: the slot map changes
                    flat = si * r_pad + slot
                    if words is None:
                        resets.append((flat, frag.row_words(r)))
                    else:
                        w_arr = np.fromiter(words, np.int64, len(words))
                        vals = frag.row_words(r, w_arr)
                        cells.update(zip(((flat, w) for w in w_arr.tolist()),
                                         vals.tolist()))
                    if len(cells) + 64 * len(resets) > cap:
                        return None
                actual[si] = frag.generation
        return cells, resets, tuple(actual)

    def _delta_update(self, key, field: Field, view_name: str,
                      shards: tuple[int, ...], hit):
        """A stale "plane" entry brought to serving truth without a
        rebuild: absorbed into the overlay, else folded.  None = rebuild."""
        ps = self._delta_absorb(key, field, view_name, shards, hit)
        if ps is not None:
            return ps
        with self._lock:
            hit = self._entries.get(key)
        if hit is None:
            return None
        return self._fold(key, field, view_name, shards, hit)

    def _delta_absorb(self, key, field: Field, view_name: str,
                      shards: tuple[int, ...], hit):
        """Absorb journal cells into the entry's device overlay and move
        its generations forward; the base plane is not touched.  None =
        cannot (overlays off, whole-row ops, overlay full, journal gap).
        Past the compaction fill the background compactor starts."""
        if self.delta_cells <= 0:
            return None
        old_gens, ps, nbytes = hit
        got = self._collect_changes(field, view_name, shards, hit,
                                    self.delta_cells)
        if got is None:
            return None
        cells, resets, actual = got
        if resets:
            return None  # whole-row replacements fold instead
        with self._lock:
            cur = self._entries.get(key)
            if cur is None or cur[1] is not ps:
                # raced another absorb, fold or build
                if cur is not None and cur[0] == actual:
                    return cur[1]
                return None
            if actual == tuple(old_gens):
                return ps
            mir = self._delta_mirrors.get(key)
            if mir is None or mir[0] is not ps.plane:
                mir = (ps.plane, DeltaMirror(self.delta_cells))
                self._delta_mirrors[key] = mir
            mirror = mir[1]
            if not mirror.would_fit(cells):
                return None  # overlay full: fold
            mirror.absorb(cells)
            overlay = self._overlay(mirror, ps.plane, bsi=key[0] == "bsi")
            new_ps = PlaneSet(ps.plane, ps.shards, ps.row_ids, ps.slot_of,
                              delta=overlay)
            self._entries[key] = (actual, new_ps, nbytes)
            self._entries.move_to_end(key)
            self.delta_absorbs += 1
            fill = len(mirror) / max(1, self.delta_cells)
        if fill >= self.delta_compact_fraction:
            self._compact_async(key, field, view_name, shards)
        return new_ps

    def _overlay(self, mirror: DeltaMirror, plane, bsi: bool):
        """The mirror's device overlay over ``plane``: split by block for
        a blocked plane, word-column grouped for a bit plane."""
        if isinstance(plane, Blocked):
            return mirror.build_blocked(plane.layout,
                                        [b.device for b in plane.blocks],
                                        plane.shape[1], bsi=bsi)
        if bsi:
            return mirror.build_bsi_overlay(self.device, plane.shape[1],
                                            plane.shape[0])
        return mirror.build_overlay(self.device,
                                    plane.shape[0] * plane.shape[1])

    # a concurrent absorb or fold replaced the entry mid-fold: retry
    # against the new entry (not a rebuild signal)
    _RACED = object()

    def _fold(self, key, field: Field, view_name: str,
              shards: tuple[int, ...], hit):
        """Fold the entry's overlay plus any remaining journal gap into a
        new base plane in one scatter and swap the entry to it, clean, at
        the new generations.  Retries when a concurrent absorb swaps the
        entry mid-fold; None when the gap is not coverable (rebuild)."""
        for _ in range(8):
            out = self._fold_once(key, field, view_name, shards, hit)
            if out is not self._RACED:
                return out
            with self._lock:
                hit = self._entries.get(key)
            if hit is None:
                return None
        return None

    def _fold_once(self, key, field: Field, view_name: str,
                   shards: tuple[int, ...], hit):
        old_gens, ps, _ = hit
        got = self._collect_changes(field, view_name, shards, hit,
                                    self.delta_cells + self.MAX_INCR_CELLS)
        if got is None:
            return None
        cells, resets, actual = got
        t0 = time.perf_counter()
        with self._lock:
            cur = self._entries.get(key)
            if cur is None or cur[1] is not ps:
                if (cur is not None and cur[0] == actual
                        and cur[1].delta is None):
                    return cur[1]
                return self._RACED if cur is not None else None
            mir = self._delta_mirrors.get(key)
            mirror_cells = (mir[1].snapshot()
                            if mir is not None and mir[0] is ps.plane
                            else {})
        if ps.delta is not None and not mirror_cells:
            # an overlay whose mirror is gone cannot be recovered on the
            # host: rebuild rather than lose its cells
            return None
        if not cells and not resets and not mirror_cells:
            if actual == tuple(old_gens):
                return ps
            new_ps = ps  # generations moved with nothing to scatter
        else:
            reset_set = {fr for fr, _ in resets}
            # whole-row resets supersede mirror cells of their rows, and
            # journal truth supersedes the mirror
            merged = {k: v for k, v in mirror_cells.items()
                      if k[0] not in reset_set}
            merged.update(cells)
            new_plane = _apply_plane_cells(
                ps.plane,
                np.fromiter((k[0] for k in merged), np.int64, len(merged)),
                np.fromiter((k[1] for k in merged), np.int64, len(merged)),
                np.fromiter(merged.values(), np.uint32, len(merged)),
                [fr for fr, _ in resets],
                (np.stack([rv for _, rv in resets]) if resets
                 else np.zeros((0, ps.plane.shape[-1]), np.uint32)))
            _sync(new_plane)  # the fold's time includes its device work
            new_ps = PlaneSet(new_plane, ps.shards, ps.row_ids, ps.slot_of)
        with self._lock:
            if not self._swap(key, ps, actual, new_ps):
                return (self._RACED if key in self._entries else None)
            self._delta_mirrors.pop(key, None)
            self.incremental_applied += 1
            if mirror_cells or ps.delta is not None:
                self.delta_compactions += 1
                self.last_compaction_seconds = time.perf_counter() - t0
                self._stats.count("delta_compactions_total", 1)
        return new_ps

    def _compact_async(self, key, field: Field, view_name: str,
                       shards: tuple[int, ...]) -> None:
        """Start the background compactor for one plane, single-flight
        per key: it folds the overlay off the request path."""
        with self._lock:
            if key in self._compacting:
                return
            t = threading.Thread(target=self._compact_run,
                                 args=(key, field, view_name, shards),
                                 name="delta-compact", daemon=True)
            self._compacting[key] = t
        t.start()

    def _compact_run(self, key, field: Field, view_name: str,
                     shards: tuple[int, ...]) -> None:
        try:
            with self._lock:
                hit = self._entries.get(key)
            if hit is not None:
                self._fold(key, field, view_name, shards, hit)
        except Exception:  # noqa: BLE001 — requests keep base+delta
            logging.getLogger("pilosa_tpu_torch.exec").exception(
                "delta compaction failed for %s (requests keep answering "
                "base+delta; the next absorb past the fill retries)", key)
        finally:
            with self._lock:
                self._compacting.pop(key, None)

    def _incremental(self, key, field: Field, view_name: str,
                     shards: tuple[int, ...], hit):
        """Refresh a stale single-row or selected-rows entry from the
        journals into a new tensor instead of re-expanding every fragment:
        a single row takes its current words on the shards where it
        changed; a rows plane takes the changed words of its own rows
        (whole rows after whole-row ops) and skips the rows outside its
        selection.  It never folds: the set plane's fold maps every row
        through the slot map and would refuse or misplace a selection's
        cells.  None = rebuild (journal gap, more than
        ``MAX_INCR_CELLS`` cells; a whole row counts 64)."""
        old_gens, ps, _ = hit
        view = field.view(view_name)
        if view is None or len(old_gens) != len(shards):
            return None
        single = key[0] == "row"
        r_pad = 1 if single else ps.plane.shape[1]
        cell_rows, cell_words, cell_vals = [], [], []
        reset_rows, reset_vals = [], []
        actual = list(old_gens)
        for si, s in enumerate(shards):
            frag = view.fragment(s)
            if frag is None:
                if old_gens[si] != -1:
                    return None
                continue
            with frag.lock:
                if old_gens[si] == -1:
                    return None
                if frag.generation == old_gens[si]:
                    continue
                changed = frag.changed_cells_since(old_gens[si])
                if changed is None:
                    return None
                for r, words in changed.items():
                    slot = ps.slot_of.get(int(r))
                    if slot is None:
                        continue  # outside the selection
                    flat = si * r_pad + slot
                    if words is None or single:
                        reset_rows.append(flat)
                        reset_vals.append(frag.row_words(r))
                    else:
                        w_arr = np.fromiter(words, np.int64, len(words))
                        cell_rows.extend([flat] * len(w_arr))
                        cell_words.extend(w_arr.tolist())
                        cell_vals.extend(frag.row_words(r, w_arr).tolist())
                    if (len(cell_rows) + 64 * len(reset_rows)
                            > self.MAX_INCR_CELLS):
                        return None
                actual[si] = frag.generation
        new_plane = ps.plane
        if cell_rows or reset_rows:
            new_plane = _apply_plane_cells(
                ps.plane, cell_rows, cell_words,
                np.asarray(cell_vals, np.uint32), reset_rows,
                (np.stack(reset_vals) if reset_vals
                 else np.zeros((0, ps.plane.shape[-1]), np.uint32)))
        new_ps = PlaneSet(new_plane, ps.shards, ps.row_ids, ps.slot_of)
        with self._lock:
            self._swap(key, ps, actual, new_ps)
            self.incremental_applied += 1
        return new_ps

    def _build_bsi(self, field: Field, view_name: str,
                   shards: tuple[int, ...]) -> PlaneSet:
        """The fixed BSI rows 0 .. depth + 1, unpadded."""
        n_rows = OFFSET_ROW + field.options.bit_depth
        return self._build_plane(field, view_name, shards,
                                 np.arange(n_rows, dtype=np.uint64), n_rows)

    def _build_plane(self, field: Field, view_name: str,
                     shards: tuple[int, ...],
                     row_ids: np.ndarray | None = None,
                     r_pad: int | None = None) -> PlaneSet:
        """``row_ids`` at slots 0.. of an ``r_pad``-row plane, or every
        row id of the view padded to a power of two."""
        if row_ids is None:
            row_ids = union_row_ids(field, view_name, shards)
            r_pad = pow2_bucket(len(row_ids))
        return self.build_rows_plane(field, view_name, shards, row_ids,
                                     r_pad)

    def assemble(self, shards: tuple[int, ...], r_pad: int,
                 sources, tally: bool = True, warm_tally: bool = True,
                 sidecars: bool | None = None,
                 sidecar_write: bool | None = None) -> torch.Tensor:
        """A new ``int32[len(shards), r_pad, W]`` device tensor holding, for
        each ``(view, row_ids, slots)`` of ``sources``, row ``row_ids[i]``
        of the view's fragment of every shard at slot ``slots[i]`` (absent
        fragments and rows leave zeros).  Fragments expand chunk by chunk
        into a pinned host staging buffer, each chunk's fragments at once
        on the builder threads, and each chunk is copied into the device
        tensor while the next one expands; it returns once every copy has
        landed.  ``tally=False`` (a page-in, a streamed block) leaves the
        build counters alone; ``warm_tally=False`` (a streamed block,
        which visits each fragment once per block) the sidecar ones.
        ``sidecars`` overrides the cache's setting for this build;
        ``sidecar_write`` whether cold expansions write images (default:
        a build past ``SYNC_BUILD_MAX`` bytes).  Under a placement the
        tensor is :class:`Blocked`: each chunk is copied into the blocks
        it spans."""
        t0 = time.perf_counter()
        shape = (len(shards), r_pad, WORDS_PER_SHARD)
        if self.placement is not None:
            full = self.placement.zeros(shape)
            targets = list(zip(full.layout, full.blocks))
        else:
            full = torch.empty(shape, dtype=torch.int32, device=self.device)
            targets = [((0, len(shards), None, None), full)]
        slab = r_pad * WORDS_PER_SHARD * 4
        spc = max(1, min(len(shards), self.BUILD_CHUNK_BYTES // slab))
        cuda = self.device.type == "cuda"
        bufs = [torch.empty((spc, r_pad, WORDS_PER_SHARD),
                            dtype=torch.int32, pin_memory=cuda)
                for _ in range(2 if len(shards) > spc else 1)]
        copied: list = [None] * len(bufs)
        sources = [(view, np.asarray(row_ids, np.uint64),
                    np.asarray(slots, np.uint64))
                   for view, row_ids, slots in sources
                   if view is not None and len(row_ids)]
        sidecars = self.sidecars if sidecars is None else sidecars
        if sidecar_write is None:
            sidecar_write = len(shards) * slab > self.SYNC_BUILD_MAX
        sidecar_write = sidecars and sidecar_write
        token = object()
        with self._lock:
            self._assembling[id(token)] = tuple(
                view.path for view, _, _ in sources)
        writer = (_SidecarWriter(self) if sidecar_write and sources
                  else None)
        workers = min(self.BUILD_WORKERS, len(shards) * len(sources))
        pool = ThreadPoolExecutor(workers) if workers > 1 else None
        try:
            for ci, s0 in enumerate(range(0, len(shards), spc)):
                glen = min(spc, len(shards) - s0)
                par = ci % len(bufs)
                for ev in copied[par] or ():
                    ev.synchronize()  # its last copies have landed
                host = bufs[par].numpy().view(np.uint32)[:glen]
                host.fill(0)
                tasks = []
                for view, row_ids, slots in sources:
                    for li, s in enumerate(shards[s0:s0 + glen]):
                        frag = view.fragment(s)
                        if frag is not None:
                            tasks.append(partial(
                                frag.expand_rows_into, row_ids, host[li],
                                slots, sidecar=sidecars,
                                sidecar_write=sidecar_write,
                                sidecar_submit=(writer.submit if writer
                                                else None)))
                self._expand_tasks(pool, tasks, warm_tally and sidecars)
                copied[par] = _copy_chunk(targets, s0, s0 + glen,
                                          bufs[par], cuda)
            for evs in copied:
                for ev in evs or ():
                    ev.synchronize()
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
            if writer is not None:
                writer.close()
            with self._lock:
                del self._assembling[id(token)]
                self._assembled.notify_all()
        if tally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.builds += 1
                self.last_build_seconds = dt
                self.last_build_bytes = full.numel() * 4
                self.build_seconds_total += dt
                self.build_bytes_total += full.numel() * 4
            self._stats.observe("plane_build_seconds", dt)
            self._stats.count("plane_build_bytes_total", full.numel() * 4)
        return full

    def _expand_tasks(self, pool, tasks, tally: bool = True) -> None:
        """Run fragment expansions on the builder pool (inline without
        one), tally warm and cold, one per fragment, and re-raise the
        first failure: a build never ships a half-expanded chunk."""
        if pool is None:
            modes = [t() for t in tasks]
        else:
            futs = [pool.submit(t) for t in tasks]
            wait(futs)
            modes = [f.result() for f in futs]
        if not tally:
            return
        hits = sum(m == "warm" for m in modes)
        with self._lock:
            self.warm_hits += hits
            self.warm_misses += len(modes) - hits
        if hits:
            self._stats.count("plane_cache_warm_hits_total", hits)
        if len(modes) - hits:
            self._stats.count("plane_cache_warm_misses_total",
                              len(modes) - hits)

    def _build_row(self, field: Field, view_name: str,
                   shards: tuple[int, ...], row_id: int) -> PlaneSet:
        """One row across shards, through the builder pool like a plane,
        from the snapshots: checking a sidecar's crc reads its whole image,
        more than expanding one row costs."""
        full = self.assemble(shards, 1, [(field.view(view_name),
                                          np.array([row_id], np.uint64),
                                          np.zeros(1, np.uint64))],
                             tally=False, sidecars=False)
        return PlaneSet(full[:, 0], shards, np.array([row_id], np.uint64),
                        {row_id: 0})


class _SidecarWriter:
    """One thread writing sidecar images handed over by the builders,
    through a bounded queue: a slow disk backpressures the build."""

    def __init__(self, cache: PlaneCache):
        self.cache = cache
        self.q: queue.Queue = queue.Queue(maxsize=cache.SIDECAR_QUEUE)
        self.thread = threading.Thread(target=self._run,
                                       name="plane-sidecar", daemon=True)
        self.thread.start()

    def submit(self, path: str, hdr: bytes, blob: bytes) -> None:
        self.q.put((path, hdr, blob))

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            t0 = time.perf_counter()
            Fragment.write_sidecar_file(*item)
            dt = time.perf_counter() - t0
            with self.cache._lock:
                self.cache.sidecar_bytes_written += len(item[1]) + len(
                    item[2])
                self.cache.sidecar_write_seconds += dt

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()


def _copy_chunk(targets: list, c0: int, c1: int, buf: torch.Tensor,
                cuda: bool) -> list:
    """Copy staged shards ``[c0, c1)`` (``buf[:c1 - c0]``) into every
    target block ``((s0, s1, w0, w1), tensor)`` they overlap; on CUDA
    returns one event per copy's device, recorded after it."""
    devices = set()
    for (s0, s1, w0, w1), dst in targets:
        a, b = max(c0, s0), min(c1, s1)
        if a >= b:
            continue
        src = buf[a - c0:b - c0]
        if w0 is not None:
            src = src[..., w0:w1]
        dst[a - s0:b - s0].copy_(src, non_blocking=cuda)
        devices.add(dst.device)
    evs = []
    for dev in devices if cuda else ():
        evs.append(torch.cuda.Event())
        evs[-1].record(torch.cuda.current_stream(dev))
    return evs


def _sync(t: torch.Tensor) -> None:
    """Wait for the work that produces ``t`` (CUDA); a no-op on the CPU."""
    if isinstance(t, Blocked):
        for blk in t.blocks:
            _sync(blk)
        return
    if t.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()


def union_row_ids(field: Field, view_name: str,
                   shards: tuple[int, ...]) -> np.ndarray:
    """Sorted distinct row ids across shards."""
    view = field.view(view_name)
    parts = []
    if view is not None:
        for s in shards:
            frag = view.fragment(s)
            if frag is not None:
                parts.append(frag.row_ids_array())
    if not parts:
        return np.empty(0, np.uint64)
    return np.unique(np.concatenate(parts))


def _bytes_by_device(plane: Blocked) -> dict[str, int]:
    """A blocked plane's bytes on each device (blocks on one device add
    into its entry)."""
    out: dict[str, int] = {}
    for blk in plane.blocks:
        out[str(blk.device)] = out.get(str(blk.device), 0) + blk.nbytes
    return out
