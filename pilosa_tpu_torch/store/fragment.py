"""Fragment: the bits of one (field, view, shard).

The on-disk contract of ``pilosa_tpu.store.fragment``: a roaring snapshot
file (framed ``PSF1`` header + crc32, or a legacy unframed pilosa-format
blob) beside a CRC-framed op-log, positions encoded
``row * SHARD_WIDTH + column``.  The port opens fragments the JAX package
wrote and writes fragments it opens.

Host state is two tiers: rows still only in the mmap'd snapshot
(``_snap_pending``, expanded on demand straight from the blob; past
:data:`syswrap.GLOBAL`'s cap of live maps the oldest snapshots are read
from heap copies instead) and
materialized rows, which every write goes through.  A materialized row is
held as sorted unique uint32 column offsets (``rows``) while it has at
most ``DENSE_MIN_BITS`` bits, else as its packed ``uint32[W]`` words
(``dense``): a write to a dense row flips words in place instead of
re-sorting a quarter-million offsets.  A snapshot row stored in a bitmap
container is materialized as words too: copying the container is far
cheaper than listing its bits.  A row id is in at most one of the
three.

A ``<snapshot>.dense`` sidecar (the reference's format, byte for byte)
holds the fragment's rows as an all-bitmap image, stamped with the
on-disk state it captured: a plane build reads a fresh one at memcpy
speed instead of expanding the snapshot, and a cold expansion over the
fragment's full row set writes one (:meth:`Fragment.expand_rows_into`).
Snapshot rows expand, and snapshots serialize, through the native codec
(:mod:`.native`).  Past ``max_op_n`` op-log records a fragment hands
itself to ``snapshot_submit`` (the holder's background queue) when it
has one, else compacts inline.

``generation`` moves on every mutation that changes a bit; the device
plane cache keys on it.  ``_recent`` journals which (row, word) cells
each generation touched, so a resident plane can absorb a write gap
(:meth:`Fragment.changed_cells_since`) instead of rebuilding.

Anti-entropy and replica repair read and write a fragment through
:meth:`Fragment.blocks` (per-block checksums, cached per generation),
:meth:`Fragment.block_positions`, :meth:`Fragment.merge_positions` (a
union journaled like any set write, so a resident plane absorbs it) and
:meth:`Fragment.rebuild_from_positions` (a wholesale replacement that
leaves a gap marker, so a resident plane rebuilds).
"""

from __future__ import annotations

import logging
import mmap
import os
import struct
import threading
import zlib
from collections import deque

import numpy as np

from pilosa_tpu_torch.engine.words import (SHARD_WIDTH, WORDS_PER_SHARD,
                                           pack_columns, unpack_columns)
from pilosa_tpu_torch.store import health as _storage_health
from pilosa_tpu_torch.store import native, roaring, syswrap
from pilosa_tpu_torch.store.oplog import (OP_CLEAR_BITS, OP_CLEAR_ROW,
                                          OP_SET_BITS, OP_SET_ROW,
                                          RAW_MAX_POSITIONS, OpLog)

# compact the op-log into a snapshot after this many records
MAX_OP_N = 2000

# rows per anti-entropy checksum block (the reference's HashBlockSize)
HASH_BLOCK_SIZE = 100

# a materialized row with more set bits than this is held as packed
# words (a uint32 offset per bit would outweigh the 128 KiB of words)
DENSE_MIN_BITS = WORDS_PER_SHARD

_SW = np.uint64(SHARD_WIDTH)
_ROW_SHIFT = np.uint64(SHARD_WIDTH.bit_length() - 1)  # position >> 20: row
_COL_MASK = np.uint64(SHARD_WIDTH - 1)                # position & mask: col
_EMPTY = np.empty(0, np.uint32)
_ONE = np.uint32(1)


class Fragment:
    SNAP_MAGIC = b"PSF1"
    SNAP_VERSION = 1
    _SNAP_HDR = struct.Struct("<4sHHQI")  # magic, ver, rsvd, len, crc

    # journal bounds (``pilosa_tpu.store.fragment``'s): past RECENT_MAX
    # entries the oldest fall off, and an op touching more cells than
    # RECENT_CELL_CAP leaves a gap marker; either way a plane behind the
    # gap rebuilds
    RECENT_MAX = 128
    RECENT_CELL_CAP = 65536
    # set batches under this many positions journal only the words of
    # the bits they newly set (the reference's pending-tier entries);
    # larger batches and clears journal every word they name
    PEND_FLUSH_N = 65536

    # <snapshot>.dense: header (magic, version, reserved, the stamp's
    # snapshot size, snapshot mtime_ns and op-log size, image length,
    # crc32 of the image) + a serialize_dense image of the full rows
    DENSE_MAGIC = b"PDN1"
    DENSE_VERSION = 1
    _DENSE_HDR = struct.Struct("<4sHHQQQQI")

    def __init__(self, path: str, shard: int, *, max_op_n: int = MAX_OP_N,
                 fsync: bool = False, snapshot_submit=None, health=None):
        self.path = path                      # snapshot file
        self.shard = shard
        self.max_op_n = max_op_n
        # the holder's disk-health governor and quarantine registry
        # (:class:`~.health.StorageHealth`; None: no gate, corruption
        # is only logged)
        self._health = health
        # set: op-log compaction goes to this background queue instead of
        # running on the write path
        self._snapshot_submit = snapshot_submit
        self.rows: dict[int, np.ndarray] = {}
        self.dense: dict[int, np.ndarray] = {}
        self.op_n = 0
        self.generation = 0
        self.lock = threading.RLock()
        self._oplog = OpLog(path + ".oplog", fsync=fsync)
        self._open = False
        self._snap_mm = None
        self._snap_dir: roaring.Directory | None = None
        self._snap_pending: set[int] = set()
        # the framed snapshot's crc32 (None: legacy unframed), checked
        # again when the map is demoted to a heap copy
        self._snap_crc: int | None = None
        # (generation, {row: word indices | None = whole row} | None =
        # gap) per bit-changing op
        self._recent: deque = deque(maxlen=self.RECENT_MAX)
        # (generation, {block: crc32}) of the last blocks() answer
        self._blocks_cache: tuple | None = None
        # set while rebuild_from_positions compacts a quarantined fragment
        self._rebuilding = False

    # -- lifecycle ----------------------------------------------------------

    def open(self) -> "Fragment":
        with self.lock:
            if self._open:
                return self
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                try:
                    self._open_snapshot()
                except Exception as e:  # noqa: BLE001 — a corrupt
                    # snapshot quarantines this fragment, never the
                    # whole holder open
                    self._mark_corrupt("snapshot", f"open failed: {e}")
            for op, aux, positions in self._oplog.replay():
                self._apply(op, aux, positions)
                self.op_n += 1
            self._open = True
        return self

    def _open_snapshot(self) -> None:
        """mmap the snapshot and parse only its container directory.  A
        framed snapshot's crc is verified before any bit is served: a
        mismatch (or a truncated header, an unknown version) quarantines
        the fragment through :meth:`_mark_corrupt`, which then serves
        what its op-log holds."""
        with open(self.path, "rb") as f:
            head = f.read(self._SNAP_HDR.size)
            framed = head[:4] == self.SNAP_MAGIC
            legacy = (not framed and len(head) >= 2
                      and struct.unpack("<H", head[:2])[0] == roaring.MAGIC)
            if not (framed or legacy):
                # non-pilosa (standard32) snapshot: eager load
                f.seek(0)
                self._load_positions(roaring.deserialize(f.read()))
                return
            crc = None
            if framed:
                if len(head) < self._SNAP_HDR.size:
                    self._mark_corrupt("snapshot", "truncated frame header")
                    return
                _, ver, _, blen, crc = self._SNAP_HDR.unpack(head)
                if ver != self.SNAP_VERSION:
                    self._mark_corrupt("snapshot",
                                       f"unknown frame version {ver}")
                    return
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        blob = memoryview(mm)
        if framed:
            blob = blob[self._SNAP_HDR.size:]
            # zlib releases the interpreter lock: concurrent opens overlap
            if len(blob) != blen or zlib.crc32(blob) != crc:
                del blob
                try:
                    mm.close()
                except BufferError:
                    pass
                self._mark_corrupt(
                    "snapshot", "frame length/crc mismatch (disk corruption)")
                return
        self._snap_mm = mm
        self._snap_crc = crc
        self._snap_dir = roaring.Directory(blob)
        self._snap_pending = set(self._snap_dir.row_ids().tolist())
        syswrap.GLOBAL.register(self)

    def _demote_map(self) -> bool:
        """Read the snapshot from a heap copy and release the map (and its
        file descriptor) when the last view of it dies.  False when the
        fragment's lock stays taken: the caller keeps tracking it."""
        if not self.lock.acquire(timeout=1.0):
            return False
        try:
            if self._snap_mm is not None and self._snap_dir is not None:
                heap = bytes(self._snap_dir.buf)
                if self._snap_crc is not None \
                        and zlib.crc32(heap) != self._snap_crc:
                    # the mapped bytes changed under the map: the copy is
                    # poisoned, quarantine instead of serving it
                    self._mark_corrupt("snapshot",
                                       "crc mismatch at mmap demotion")
                    return True
                self._snap_dir = roaring.Directory(memoryview(heap))
                self._snap_mm = None
            return True
        finally:
            self.lock.release()

    def poison_snapshot(self) -> None:
        """Scrub-detected corruption of a live fragment's snapshot: drop
        the map, so no pending row expands from the corrupt blob, and
        move the generation past a gap marker, so a resident plane built
        over the bad bytes rebuilds.  The registry entry is the
        caller's."""
        with self.lock:
            self._drop_snapshot()
            self._snap_crc = None
            self.generation += 1
            self._recent.clear()
            self._recent.append((self.generation, None))

    def _mark_corrupt(self, kind: str, detail: str) -> None:
        """Quarantine this fragment after a checksum (or parse) failure:
        drop the snapshot and serve what the op-log holds; with no
        governor the failure is only logged."""
        self._drop_snapshot()
        self._snap_crc = None
        if self._health is not None:
            self._health.quarantine(self.path, kind, detail)
        else:
            logging.getLogger("pilosa_tpu_torch.store").error(
                "fragment snapshot corrupt (%s) at %s: %s",
                kind, self.path, detail)

    def _drop_snapshot(self) -> None:
        syswrap.GLOBAL.release(self)
        self._snap_dir = None
        self._snap_pending = set()
        if self._snap_mm is not None:
            try:
                self._snap_mm.close()
            except BufferError:
                pass  # views still alive; the map closes when they die
            self._snap_mm = None

    def close(self) -> None:
        with self.lock:
            if self.op_n > 0:
                self.snapshot()
            self._drop_snapshot()
            self._open = False

    def discard(self) -> None:
        """Close a fragment whose files are about to be removed: its
        op-log state is dropped, not compacted (the reference compacts it
        on close, then removes the file).  Taking the lock waits out a
        compaction in progress; a later one finds the fragment closed, and
        an expansion finds no rows, so it writes no ``.dense`` image."""
        with self.lock:
            self._drop_snapshot()
            self.rows = {}
            self.dense = {}
            self._recent.clear()
            self._rc_cache = None
            self.op_n = 0
            self._open = False

    # -- reads --------------------------------------------------------------

    def _ensure_row(self, row_id: int) -> None:
        """Materialize one snapshot-resident row."""
        if row_id in self._snap_pending:
            self._snap_pending.discard(row_id)
            if (self._snap_dir.row_cardinality(row_id) > DENSE_MIN_BITS
                    or self._snap_dir.row_has_bitmap(row_id)):
                words = np.zeros(WORDS_PER_SHARD, np.uint32)
                self._snap_dir.row_words(row_id, words)
                self.dense[row_id] = words
            else:
                cols = self._snap_dir.expand_row(row_id)
                if len(cols):
                    self.rows[row_id] = cols

    def row_ids_array(self) -> np.ndarray:
        """Live row ids as a uint64 array (unsorted)."""
        with self.lock:
            ids = list(self.rows) + list(self.dense) + list(self._snap_pending)
            return np.fromiter(ids, np.uint64, len(ids))

    def row_ids(self) -> list[int]:
        """Live row ids, sorted."""
        return sorted(int(r) for r in self.row_ids_array())

    @property
    def present(self) -> bool:
        return bool(self.rows) or bool(self.dense) or bool(self._snap_pending)

    def positions(self) -> np.ndarray:
        """All set bits as sorted uint64 ``row*SHARD_WIDTH + col``."""
        with self.lock:
            snap = None
            pend = self._snap_pending
            rowed: list = []  # (row, sorted uint64 positions)
            if pend and len(pend) * 4 >= len(self._snap_dir.row_cards()[0]):
                # most snapshot rows unread: one native decode of the
                # blob, the materialized rows filtered out
                snap = native.deserialize(self._snap_dir.buf)
                if not self._snap_dir._keys_sorted:
                    snap = np.sort(snap)
                if len(pend) != len(self._snap_dir.row_cards()[0]):
                    snap = snap[np.isin(snap // _SW, np.fromiter(
                        pend, np.uint64, len(pend)))]
            else:
                rowed += [(r, self._snap_dir.expand_row(r).astype(np.uint64))
                          for r in pend]
            rowed += [(r, cols.astype(np.uint64))
                      for r, cols in self.rows.items()]
            rowed += [(r, unpack_columns(words))
                      for r, words in self.dense.items()]
        # a row lives in one tier and each row's columns are sorted, so
        # the rows in row order concatenate sorted
        rowed.sort(key=lambda t: t[0])
        parts = [np.uint64(r) * _SW + cols for r, cols in rowed]
        if snap is None:
            return np.concatenate(parts) if parts else np.empty(0, np.uint64)
        if not parts:
            return snap
        return np.sort(np.concatenate([snap] + parts))

    def row_cardinalities(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ids uint64[R] sorted, cards int64[R]) with no bit expanded:
        directory sums for snapshot-resident rows, the offset count or the
        words' popcount for materialized ones (a row lives in one tier).
        Cached per generation: budget checks ask on every request."""
        with self.lock:
            hit = getattr(self, "_rc_cache", None)
            if hit is not None and hit[0] == self.generation:
                return hit[1]
            out = self._row_cardinalities()
            self._rc_cache = (self.generation, out)
            return out

    def _row_cardinalities(self) -> tuple[np.ndarray, np.ndarray]:
        with self.lock:
            ids, cards = [], []
            if self._snap_pending and self._snap_dir is not None:
                uniq, ucards = self._snap_dir.row_cards()
                if len(self._snap_pending) != len(uniq):
                    keep = np.isin(uniq, np.fromiter(
                        self._snap_pending, np.uint64,
                        len(self._snap_pending)))
                    uniq, ucards = uniq[keep], ucards[keep]
                ids.append(uniq)
                cards.append(ucards)
            if self.rows:
                ids.append(np.fromiter(self.rows, np.uint64, len(self.rows)))
                cards.append(np.fromiter((len(c) for c in self.rows.values()),
                                         np.int64, len(self.rows)))
            if self.dense:
                ids.append(np.fromiter(self.dense, np.uint64, len(self.dense)))
                cards.append(np.fromiter(
                    (int(np.bitwise_count(w).sum())
                     for w in self.dense.values()), np.int64, len(self.dense)))
            snap_only = len(ids) == 1 and not (self.rows or self.dense)
        if not ids:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        if snap_only:
            return ids[0], cards[0]
        all_ids = np.concatenate(ids)
        order = np.argsort(all_ids, kind="stable")
        return all_ids[order], np.concatenate(cards)[order]

    def cardinality(self) -> int:
        """Set bits in the fragment, from :meth:`row_cardinalities`."""
        return int(self.row_cardinalities()[1].sum())

    def row_words(self, row_id: int, word_idx=None) -> np.ndarray:
        """One row's current packed words, uint32[W] (a copy), or just the
        words at ``word_idx``: the reference's ``frag.row(r).words()``."""
        with self.lock:
            words = self.dense.get(row_id)
            if words is None:
                if row_id in self._snap_pending:
                    words = np.zeros(WORDS_PER_SHARD, np.uint32)
                    self._snap_dir.row_words(row_id, words)
                else:
                    words = pack_columns(self.rows.get(row_id, _EMPTY))
            elif word_idx is None:
                words = words.copy()
            if word_idx is None:
                return words
            return words[np.asarray(word_idx, np.intp)]

    def rows_contain(self, row_ids, cols: np.ndarray) -> np.ndarray:
        """bool[len(row_ids), len(cols)]: whether each row holds each
        column offset, probed where the row lives (its packed words, a
        search of its sorted offsets, or the snapshot's containers, all
        snapshot rows in one probe), with nothing materialized."""
        cols = np.asarray(cols, np.uint32)
        out = np.zeros((len(row_ids), len(cols)), bool)
        word = (cols >> np.uint32(5)).astype(np.intp)
        bit = cols & np.uint32(31)
        with self.lock:
            snap = []
            for i, r in enumerate(row_ids):
                r = int(r)
                words = self.dense.get(r)
                if words is not None:
                    out[i] = (words[word] >> bit) & _ONE != 0
                elif r in self._snap_pending:
                    snap.append(i)
                else:
                    offs = self.rows.get(r, _EMPTY)
                    if len(offs):
                        at = np.minimum(np.searchsorted(offs, cols),
                                        len(offs) - 1)
                        out[i] = offs[at] == cols
            if snap:
                out[snap] = self._snap_dir.contains(
                    np.asarray(row_ids, np.uint64)[snap], cols)
        return out

    def expand_rows_into(self, row_ids, out: np.ndarray, slots=None, *,
                         sidecar: bool = False, sidecar_write: bool = True,
                         sidecar_submit=None) -> str:
        """OR ``row_ids[i]``'s packed words into ``out[slots[i]]``
        (``out`` a C-contiguous ``uint32[n, W]``; callers pass zeroed
        slabs).  Snapshot-resident rows expand straight from the blob in
        one native call, which releases the interpreter lock, so builder
        threads expanding other fragments run at the same time.

        With ``sidecar``, a fresh ``.dense`` image replaces the whole
        expansion, and (unless ``sidecar_write`` is off) a cold expansion
        that covered the fragment's full row set writes one, handed to
        ``sidecar_submit(path, header, blob)`` when given (a deferred
        writer) or written here.  Content
        and stamp are captured together under the fragment lock: a write
        racing a deferred sidecar only leaves a stale stamp, which the
        next reader rejects.  Returns ``"warm"`` or ``"cold"``."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        if slots is None:
            slots = np.arange(len(row_ids), dtype=np.uint64)
        else:
            slots = np.asarray(slots, dtype=np.uint64)
        if len(row_ids) > 1 and not (row_ids[1:] >= row_ids[:-1]).all():
            # the native lookup binary-searches row_ids: unsorted ids
            # would miss rows, not fail
            order = np.argsort(row_ids, kind="stable")
            row_ids, slots = row_ids[order], slots[order]
        with self.lock:
            if sidecar and self._expand_sidecar(row_ids, slots, out):
                return "warm"
            pend, pend_slots = [], []
            for r, s in zip(row_ids.tolist(), slots.tolist()):
                if r in self._snap_pending:
                    pend.append(r)
                    pend_slots.append(s)
                elif r in self.dense:
                    out[s] |= self.dense[r]
                else:
                    cols = self.rows.get(r)
                    if cols is not None:
                        out[s] |= pack_columns(cols, out.shape[-1])
            if pend:
                native.expand_rows_into(
                    self._snap_dir.buf, SHARD_WIDTH,
                    np.array(pend, np.uint64),
                    np.array(pend_slots, np.uint64), out)
            if sidecar and sidecar_write:
                self._write_sidecar(row_ids, slots, out, sidecar_submit)
            return "cold"

    # -- dense sidecar ------------------------------------------------------

    @property
    def dense_path(self) -> str:
        return self.path + ".dense"

    def _dense_stamp(self) -> tuple[int, int, int]:
        """The on-disk state a sidecar captures: (snapshot size, snapshot
        mtime_ns, op-log size), each (0, 0) for a snapshot never written.
        Every write grows the op-log and every compaction replaces the
        snapshot, so the stamp moves with both, across restarts too."""
        try:
            st = os.stat(self.path)
            snap = (st.st_size, st.st_mtime_ns)
        except OSError as e:
            # no snapshot yet (ENOENT) is the plain case; any other errno
            # is a disk fault: logged once and counted, and the zero stamp
            # only sends the next build cold
            _storage_health.note_os_error("fragment.stamp", self.path, e,
                                          health=self._health)
            snap = (0, 0)
        return (snap[0], snap[1], self._oplog.size())

    def _expand_sidecar(self, row_ids: np.ndarray, slots: np.ndarray,
                        out: np.ndarray) -> bool:
        """OR a valid sidecar's rows into ``out``; False when it is absent,
        stale, truncated or fails its crc (the caller expands cold and
        rewrites it).  The caller holds the lock."""
        hs = self._DENSE_HDR
        try:
            with open(self.dense_path, "rb") as f:
                hdr = f.read(hs.size)
                if len(hdr) != hs.size:
                    return False
                magic, ver, _, s0, s1, s2, blen, crc = hs.unpack(hdr)
                if (magic != self.DENSE_MAGIC or ver != self.DENSE_VERSION
                        or (s0, s1, s2) != self._dense_stamp()
                        or os.fstat(f.fileno()).st_size != hs.size + blen):
                    return False
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return False
        blob = memoryview(mm)[hs.size:]
        try:
            # an image corrupted inside can still parse: check first
            # (zlib releases the interpreter lock)
            if zlib.crc32(blob) != crc:
                return False
            native.expand_rows_into(blob, SHARD_WIDTH, row_ids, slots, out)
            return True
        except ValueError:
            return False
        finally:
            del blob
            try:
                mm.close()
            except BufferError:
                pass  # a view still alive: the map closes when it dies

    def _write_sidecar(self, row_ids: np.ndarray, slots: np.ndarray,
                       out: np.ndarray, submit=None) -> None:
        """Write the image just expanded, when it covered the fragment's
        full row set: a partial image would serve the missing rows as
        empty on the next warm read.  Best effort: a sidecar never fails
        a build."""
        live = self.row_ids_array()
        if not len(live) or not np.isin(live, row_ids).all():
            return
        stamp = self._dense_stamp()
        try:
            blob = roaring.serialize_dense(out[slots.astype(np.intp)],
                                           row_ids)
        except ValueError:
            return  # past the format's 4 GB limit: stays cold
        hdr = self._DENSE_HDR.pack(self.DENSE_MAGIC, self.DENSE_VERSION, 0,
                                   *stamp, len(blob), zlib.crc32(blob))
        if submit is not None:
            submit(self.dense_path, hdr, blob)
        else:
            self.write_sidecar_file(self.dense_path, hdr, blob,
                                    health=self._health)

    @staticmethod
    def write_sidecar_file(path: str, hdr: bytes, blob: bytes,
                           health=None) -> None:
        """Write a sidecar atomically (temp + rename), also from a deferred
        writer thread: the blob is immutable bytes.  A failure is
        swallowed (a sidecar is a cache), logged once and fed to the
        disk-health governor: an ENOSPC here is the full disk the op-log
        would hit next."""
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(hdr)
                f.write(blob)
            os.replace(tmp, path)
        except OSError as e:
            _storage_health.note_os_error("sidecar.write", path, e,
                                          health=health)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _restamp_sidecar(self, pre_stamp: tuple[int, int, int]) -> None:
        """After a compaction, which keeps the content: carry a sidecar
        that matched the state before it forward to the new stamp, and
        drop a stale one.  The caller holds the lock.  A crash in the
        rewrite only tears the header, which then fails its stamp."""
        hs = self._DENSE_HDR
        try:
            with open(self.dense_path, "r+b") as f:
                hdr = f.read(hs.size)
                if len(hdr) == hs.size:
                    magic, ver, _, s0, s1, s2, blen, crc = hs.unpack(hdr)
                    if (magic == self.DENSE_MAGIC
                            and ver == self.DENSE_VERSION
                            and (s0, s1, s2) == pre_stamp):
                        f.seek(0)
                        f.write(hs.pack(magic, ver, 0, *self._dense_stamp(),
                                        blen, crc))
                        return
        except OSError as e:
            # no sidecar (ENOENT) is the plain case
            _storage_health.note_os_error("sidecar.restamp",
                                          self.dense_path, e,
                                          health=self._health)
            return
        try:
            os.unlink(self.dense_path)
        except OSError as e:
            _storage_health.note_os_error("sidecar.unlink", self.dense_path,
                                          e, health=self._health)

    # -- mutation -----------------------------------------------------------

    def _write_gate(self) -> None:
        """Refuse a mutation before any in-memory change while the
        storage layer is sick (the node read-only on a full disk, or this
        fragment quarantined): a refusal never half-applies.  Healthy, it
        is one attribute load and a false branch."""
        h = self._health
        if h is not None and h.gate_active:
            h.check_write(self.path)

    def set_bits(self, row_ids: np.ndarray, cols: np.ndarray,
                 sync_batch=None) -> int:
        """Bulk set; returns the number of newly set bits.  ``sync_batch``
        (an :class:`~.oplog.SyncBatch`) defers the op-log fsync to the
        batch's flush: one fsync per touched log per batch."""
        return self._mutate(OP_SET_BITS, row_ids, cols, sync_batch)

    def clear_bits(self, row_ids: np.ndarray, cols: np.ndarray,
                   sync_batch=None) -> int:
        return self._mutate(OP_CLEAR_BITS, row_ids, cols, sync_batch)

    def set_bits_grouped(self, groups, sync_batch=None) -> int:
        """Bulk set from pre-grouped ``[(row_id, column offsets), ...]``
        (the shape a BSI value import builds): one op, one op-log record
        and one journal entry naming every word of every group."""
        return self._apply_grouped(OP_SET_BITS, groups, sync_batch)

    def clear_bits_grouped(self, groups, sync_batch=None) -> int:
        return self._apply_grouped(OP_CLEAR_BITS, groups, sync_batch)

    def _apply_grouped(self, op: int, groups, sync_batch=None) -> int:
        self._write_gate()
        with self.lock:
            changed = 0
            parts = []
            delta: dict = {}
            for row_id, cols in groups:
                cols = np.asarray(cols, np.uint32)
                if len(cols) == 0:
                    continue
                r = int(row_id)
                self._ensure_row(r)
                changed += len(self._row_apply(op, r, np.unique(cols)))
                words = np.unique(cols >> np.uint32(5))
                prev = delta.get(r)
                delta[r] = words if prev is None else np.union1d(prev, words)
                parts.append(np.uint64(r) * _SW + cols.astype(np.uint64))
            if changed:
                self.generation += 1
                self._note_delta(delta)
                self._log(op, 0, np.concatenate(parts), sync_batch)
            return changed

    def clear_row(self, row_id: int) -> int:
        """Clear every bit of a row: one ``OP_CLEAR_ROW`` record (none when
        the row is empty).  Returns the bits cleared."""
        self._write_gate()
        with self.lock:
            changed = self._apply(OP_CLEAR_ROW, row_id, None)
            if changed:
                self._log(OP_CLEAR_ROW, row_id, None)
            return changed

    def set_row(self, row_id: int, cols: np.ndarray) -> bool:
        """Replace a row's bits wholesale (``Store``): one ``OP_SET_ROW``
        record carrying the row's whole new content, so a replay never
        sees the row cleared without its new bits; nothing when the row
        already holds exactly ``cols``.  Returns whether it changed."""
        new = np.unique(np.asarray(cols, np.uint32))
        if len(new) and int(new[-1]) >= SHARD_WIDTH:
            raise ValueError(f"column {new[-1]} out of shard range")
        self._write_gate()
        with self.lock:
            self._ensure_row(row_id)
            words = self.dense.get(row_id)
            before = (unpack_columns(words).astype(np.uint32)
                      if words is not None
                      else self.rows.get(row_id, _EMPTY))
            if np.array_equal(before, new):
                return False
            positions = np.uint64(row_id) * _SW + new.astype(np.uint64)
            self._apply(OP_SET_ROW, row_id, positions)
            self._log(OP_SET_ROW, row_id, positions)
            return True

    def import_roaring(self, blob: bytes, clear: bool = False,
                       sync_batch=None) -> int:
        """Union (or clear) a roaring-encoded bit set (positions
        ``row*SHARD_WIDTH + col``); returns the bits changed."""
        positions = roaring.deserialize(blob)
        op = OP_CLEAR_BITS if clear else OP_SET_BITS
        self._write_gate()
        with self.lock:
            fast = None if clear else self._set_new_rows(blob, positions)
            changed, serialized = (fast if fast is not None
                                   else (self._apply(op, 0, positions), None))
            if changed:
                self._log(op, 0, positions, sync_batch, serialized)
            return changed

    def _set_new_rows(self, blob: bytes, positions: np.ndarray):
        """A set import of sorted unique ``positions`` (``blob``'s,
        already validated) whose rows the fragment does not hold yet: the
        same rows, generation and journal as :meth:`_apply`, the dense
        rows expanded from the blob in one native call.  Returns (bits
        set, the op-log payload when the rows' words make it directly,
        else None), or None when a row exists (or there are no
        positions): the caller applies them as any set."""
        d = roaring.Directory(blob)
        if not len(positions) or not d._keys_sorted:
            return None
        # per row: its first container, its bits, where it starts
        first = np.flatnonzero(np.concatenate(
            ([True], d._rows[1:] != d._rows[:-1])))
        ids = d._rows[first]
        cards = np.add.reduceat(d.cards, first)
        starts = np.concatenate(([0], np.cumsum(cards)[:-1]))
        if int(ids[-1]) >= (1 << 40):
            raise ValueError("row id out of range (>= 2^40)")
        id_list = ids.tolist()
        if any(r in self.rows or r in self.dense or r in self._snap_pending
               for r in id_list):
            return None
        dense = np.flatnonzero(cards > DENSE_MIN_BITS)
        words = np.zeros((len(dense), WORDS_PER_SHARD), np.uint32)
        if len(dense):
            native.expand_rows_into(blob, SHARD_WIDTH, ids[dense],
                                    np.arange(len(dense), dtype=np.uint64),
                                    words)
        delta: dict = {}
        for slot, i in enumerate(dense.tolist()):
            self.dense[id_list[i]] = words[slot]
            delta[id_list[i]] = np.flatnonzero(words[slot]).astype(np.uint32)
        for i in np.flatnonzero(cards <= DENSE_MIN_BITS).tolist():
            cols = (positions[starts[i]:starts[i] + cards[i]]
                    & _COL_MASK).astype(np.uint32)
            self.rows[id_list[i]] = cols
            delta[id_list[i]] = _sorted_unique(cols >> np.uint32(5))
        self.generation += 1
        self._note_delta(delta)
        serialized = None
        if (len(dense) == len(ids) and len(positions) > RAW_MAX_POSITIONS
                and _all_bitmap_containers(words)):
            serialized = roaring.serialize_dense(words, ids)
        return len(positions), serialized

    def _mutate(self, op: int, row_ids, cols, sync_batch=None) -> int:
        positions = (np.asarray(row_ids, np.uint64) * _SW
                     + np.asarray(cols, np.uint64))
        self._write_gate()
        with self.lock:
            changed = self._apply(op, 0, positions)
            if changed:
                self._log(op, 0, positions, sync_batch)
            return changed

    def _apply(self, op: int, aux: int, positions: np.ndarray | None) -> int:
        """Apply one op to memory and journal the cells it touched;
        returns bits changed.  Shared by the mutation API and op-log
        replay."""
        delta: dict = {}
        if op in (OP_CLEAR_ROW, OP_SET_ROW):
            self._ensure_row(aux)
            changed = self._drop_row(aux)
            delta[aux] = None
            if op == OP_SET_ROW and positions is not None:
                changed += self._apply_bits(OP_SET_BITS, positions, delta)
                for r in delta:
                    delta[r] = None
        elif op in (OP_SET_BITS, OP_CLEAR_BITS):
            changed = self._apply_bits(
                op, positions, delta,
                new_only=op == OP_SET_BITS
                and len(positions) < self.PEND_FLUSH_N)
        else:
            raise ValueError(f"fragment: unknown op {op}")
        if changed:
            self.generation += 1
            self._note_delta(delta)
        return changed

    def _drop_row(self, row_id: int) -> int:
        """Remove a materialized row; returns its bit count."""
        cols = self.rows.pop(row_id, None)
        words = self.dense.pop(row_id, None)
        if words is not None:
            return int(np.bitwise_count(words).sum())
        return 0 if cols is None else len(cols)

    def _apply_bits(self, op: int, positions: np.ndarray, delta: dict,
                    new_only: bool = False) -> int:
        """Set or clear bits; records ``{row: unique word indices}`` in
        ``delta``: the words of the bits newly set when ``new_only``,
        else every word the op names."""
        positions = _sorted_unique(np.asarray(positions, np.uint64))
        if not len(positions):
            return 0
        if int(positions[-1] // _SW) >= (1 << 40):
            raise ValueError("row id out of range (>= 2^40)")
        rows = positions >> _ROW_SHIFT
        starts = np.flatnonzero(np.concatenate(([True], rows[1:] != rows[:-1])))
        uniq = rows[starts]
        bounds = np.append(starts, len(positions))
        changed = 0
        for i, r in enumerate(uniq.tolist()):
            chunk = (positions[bounds[i]:bounds[i + 1]] & _COL_MASK).astype(
                np.uint32)
            self._ensure_row(r)
            hit = self._row_apply(op, r, chunk)
            changed += len(hit)
            touched = hit if new_only else chunk
            if len(touched):
                delta[r] = _sorted_unique(touched >> np.uint32(5))
        return changed

    def _row_apply(self, op: int, r: int, chunk: np.ndarray) -> np.ndarray:
        """Set or clear sorted unique ``chunk`` columns of materialized row
        ``r``; returns the columns whose bit changed."""
        if not len(chunk):
            return chunk
        words = self.dense.get(r)
        if words is not None:
            idx = (chunk >> np.uint32(5)).astype(np.intp)
            bit = _ONE << (chunk & np.uint32(31))
            was = (words[idx] & bit) != 0
            # chunk is sorted: each word's bits are one contiguous run
            first = np.flatnonzero(np.concatenate(([True],
                                                   idx[1:] != idx[:-1])))
            mask = np.bitwise_or.reduceat(bit, first)
            if op == OP_SET_BITS:
                words[idx[first]] |= mask
                return chunk[~was]
            words[idx[first]] &= ~mask
            if not words.any():
                del self.dense[r]
            return chunk[was]
        old = self.rows.get(r, _EMPTY)
        was = (np.isin(chunk, old, assume_unique=True) if len(old)
               else np.zeros(len(chunk), bool))
        if op == OP_SET_BITS:
            hit = chunk[~was]
            new = native.union_sorted_u32(old, hit)
        else:
            hit = chunk[was]
            new = native.diff_sorted_u32(old, hit)
        if len(new) > DENSE_MIN_BITS:
            self.rows.pop(r, None)
            self.dense[r] = pack_columns(new)
        elif len(new):
            self.rows[r] = new
        else:
            self.rows.pop(r, None)
        return hit

    # -- mutation journal ---------------------------------------------------

    def _note_delta(self, rows_words: dict) -> None:
        """Journal one op's touched cells: {row: word indices | None}."""
        cells = sum(64 if v is None else len(v)
                    for v in rows_words.values())
        if cells > self.RECENT_CELL_CAP:
            self._recent.clear()
            self._recent.append((self.generation, None))  # gap marker
        else:
            self._recent.append((self.generation, rows_words))

    def changed_cells_since(self, gen: int):
        """Merged ``{row: set of word indices | None = whole row}`` over
        generations (gen, current]; ``{}`` when nothing changed, None when
        the journal cannot cover the gap (the caller rebuilds)."""
        with self.lock:
            if gen == self.generation:
                return {}
            if gen > self.generation:
                # a cache ahead of this fragment: it was replaced
                return None
            entries = [(g, rw) for g, rw in self._recent if g > gen]
            if [g for g, _ in entries] != list(range(gen + 1,
                                                     self.generation + 1)):
                return None
            merged: dict = {}
            for _, rw in entries:
                if rw is None:
                    return None  # oversized op
                for r, words in rw.items():
                    if words is None or merged.get(r, 0) is None:
                        merged[r] = None
                    else:
                        merged.setdefault(r, set()).update(
                            int(w) for w in words)
            return merged

    def _log(self, op: int, aux: int, positions: np.ndarray | None,
             sync_batch=None, serialized: bytes | None = None) -> None:
        h = self._health
        try:
            self._oplog.append(op, aux, positions, sync_batch=sync_batch,
                               serialized=serialized)
        except OSError as e:
            # classified by errno: ENOSPC flips the node read-only (this
            # op is not acknowledged), repeated EIO quarantines this
            # fragment
            if h is not None and not isinstance(
                    e, _storage_health.StorageFaultError):
                raise h.write_failed(self._oplog.path, e,
                                     site="oplog.append") from e
            raise
        if h is not None:
            h.note_write_success(self.path)
        self.op_n += 1
        if self.op_n > self.max_op_n:
            if self._snapshot_submit is not None:
                self._snapshot_submit(self)  # background compaction
            else:
                self.snapshot()

    # -- anti-entropy and repair ------------------------------------------

    def blocks(self) -> dict[int, int]:
        """Per-block checksums: block ``row_id // HASH_BLOCK_SIZE``, its
        checksum the crc32 of its sorted ``<u8`` positions.  Cached per
        generation: decoding a dense fragment's positions takes about a
        second, and an unchanged fragment answers from the cache."""
        with self.lock:
            cached = self._blocks_cache
            if cached is not None and cached[0] == self.generation:
                return cached[1]
            gen = self.generation
            pos = self.positions()
        out: dict[int, int] = {}
        if len(pos):
            # positions are sorted: each block is one contiguous run
            blocks = (pos >> _ROW_SHIFT) // np.uint64(HASH_BLOCK_SIZE)
            starts = np.flatnonzero(np.concatenate(
                ([True], blocks[1:] != blocks[:-1])))
            uniq = blocks[starts].astype(np.int64)
            bounds = np.append(starts, len(pos))
            data = pos.astype("<u8")
            for i, blk in enumerate(uniq.tolist()):
                out[blk] = zlib.crc32(data[bounds[i]:bounds[i + 1]].tobytes())
        with self.lock:
            if self.generation == gen:
                self._blocks_cache = (gen, out)
        return out

    def block_positions(self, block: int) -> np.ndarray:
        """Every position of one checksum block."""
        lo = np.uint64(block * HASH_BLOCK_SIZE) * _SW
        hi = np.uint64((block + 1) * HASH_BLOCK_SIZE) * _SW
        with self.lock:
            pos = self.positions()
        return pos[(pos >= lo) & (pos < hi)]

    def merge_positions(self, positions: np.ndarray) -> int:
        """Union ``positions`` in (the anti-entropy receive path): one set
        record, journaled as any set write, so a resident plane absorbs
        the merged bits on its next read.  Returns the bits set."""
        self._write_gate()
        with self.lock:
            changed = self._apply(OP_SET_BITS, 0, positions)
            if changed:
                self._log(OP_SET_BITS, 0, positions)
            return changed

    def rebuild_from_positions(self, positions: np.ndarray) -> None:
        """Replace this fragment's whole state with ``positions`` (the
        repair of a quarantined fragment from a healthy replica): the old
        snapshot, op-log and rows go, the new bits compact into a fresh
        framed snapshot, and the generation moves past a gap marker, so a
        resident plane rebuilds.  Bypasses the write gate: this is the
        way out of quarantine."""
        with self.lock:
            self._drop_snapshot()
            self._snap_crc = None
            self.rows = {}
            self.dense = {}
            self._oplog.truncate()
            self.op_n = 0
            self._load_positions(np.asarray(positions, np.uint64))
            self.generation += 1
            self._recent.clear()
            self._recent.append((self.generation, None))
            try:
                os.unlink(self.dense_path)  # it captured the old bytes
            except OSError:
                pass
            self._rebuilding = True
            try:
                self.snapshot()
            finally:
                self._rebuilding = False

    def _snapshot_blob(self) -> bytes:
        """The snapshot's roaring bytes, ``serialize(positions())``.  When
        every row is held as words and :func:`roaring.serialize` would
        write each of their non-empty containers as a bitmap, the same
        bytes come straight from the words (no position is listed)."""
        if self.dense and not self.rows and not self._snap_pending:
            ids = sorted(self.dense)
            words = np.stack([self.dense[r] for r in ids])
            if _all_bitmap_containers(words):
                return roaring.serialize_dense(words,
                                               np.array(ids, np.uint64))
        return roaring.serialize(self.positions())

    def maybe_snapshot(self) -> None:
        """The background queue's entry point: compact only while still
        past the threshold (a fragment queued twice compacts once)."""
        with self.lock:
            if self._open and self.op_n > self.max_op_n:
                self.snapshot()

    def _load_positions(self, positions: np.ndarray) -> None:
        self._apply_bits(OP_SET_BITS, positions, {})

    # -- durability ---------------------------------------------------------

    def snapshot(self) -> None:
        """Rewrite the snapshot (framed, atomic via temp + rename),
        truncate the op-log and re-open the new file lazily.  A
        quarantined fragment is not compacted: a valid frame over what
        memory holds would mask the corruption for good."""
        h = self._health
        if (h is not None and not self._rebuilding
                and h.is_quarantined(self.path)):
            logging.getLogger("pilosa_tpu_torch.store").warning(
                "refusing to compact quarantined fragment %s "
                "(would mask corruption as valid data)", self.path)
            return
        with self.lock:
            pre_stamp = self._dense_stamp()  # the state a sidecar may match
            blob = self._snapshot_blob()
            hdr = self._SNAP_HDR.pack(self.SNAP_MAGIC, self.SNAP_VERSION,
                                      0, len(blob), zlib.crc32(blob))
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            try:
                with open(tmp, "wb") as f:
                    syswrap.checked_write(f, hdr)
                    syswrap.checked_write(f, blob)
                    f.flush()
                    syswrap.checked_fsync(f)
                os.replace(tmp, self.path)
            except OSError as e:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                if h is not None and not isinstance(
                        e, _storage_health.StorageFaultError):
                    raise h.write_failed(self.path, e,
                                         site="fragment.snapshot") from e
                raise
            self._drop_snapshot()
            self.rows = {}
            self.dense = {}
            self._open_snapshot()
            self._oplog.truncate()
            self.op_n = 0
            # compaction keeps the content: a sidecar of the state before
            # it stays valid under the new stamp
            self._restamp_sidecar(pre_stamp)



def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)``, without the sort when ``a`` is already in order
    (a roaring blob's positions, an op-log record's, their words)."""
    if len(a) < 2:
        return a
    step = a[1:] != a[:-1]
    if bool((a[1:] >= a[:-1]).all()):
        return a if step.all() else a[np.concatenate(([True], step))]
    return np.unique(a)


# uint32 words per roaring container (65536 bits)
_CONTAINER_WORDS = 65536 // 32


def _all_bitmap_containers(words: np.ndarray) -> bool:
    """Whether the serializer writes every non-empty container of these
    rows (``uint32[R, W]``) as a bitmap: more than 4096 bits (an array
    holds at most 4096) and at least 2048 runs (fewer runs encode
    smaller as a run container)."""
    conts = words.reshape(-1, _CONTAINER_WORDS)
    cards = np.bitwise_count(conts).sum(axis=1, dtype=np.int64)
    # a run starts at a set bit whose lower neighbour, in the container,
    # is clear
    carry = np.zeros_like(conts)
    carry[:, 1:] = conts[:, :-1] >> np.uint32(31)
    starts = conts & ~((conts << np.uint32(1)) | carry)
    runs = np.bitwise_count(starts).sum(axis=1, dtype=np.int64)
    live = cards > 0
    return bool(((cards[live] > 4096) & (runs[live] >= 2048)).all())
