"""Roaring bitmap file codec (host/disk format).

Device side is dense packed words (SURVEY.md §8); roaring remains the
disk/interchange format for compactness and reference compatibility.

Two formats:

- **Pilosa 64-bit format** (primary, used for fragment snapshots).
  Layout reconstructed from memory of the reference
  (``roaring/roaring.go#WriteTo/UnmarshalBinary`` — unverified, the
  reference tree was not available; see SURVEY.md §0):

      bytes 0:2   magic   = 12348  (uint16 LE)
      bytes 2:4   version = 0      (uint16 LE)
      bytes 4:8   container count  (uint32 LE)
      per container, 12-byte descriptive header:
          key (uint64 LE, = position >> 16), type (uint16: 1=array,
          2=bitmap, 3=run), cardinality-1 (uint16)
      per container, offset header: uint32 LE byte offset of its data
      container data:
          array:  sorted uint16 LE values
          bitmap: 1024 × uint64 LE (8192 bytes)
          run:    uint16 run count, then (start, last) uint16 LE pairs
                  (inclusive intervals, as the reference's interval16)

- **Standard 32-bit roaring** (``RoaringFormatSpec``: cookies 12346/12347)
  for interop with other roaring implementations; read only.  Runs here are (start, length-1) pairs
  per the public spec — note the difference from the pilosa format.

A copy of ``pilosa_tpu.store.roaring``'s reader and writers: the port
writes byte-identical files and reads every file the JAX package writes.
:func:`serialize` and the pilosa-format :func:`deserialize` go through the
native codec (:mod:`pilosa_tpu_torch.store.native`), as the reference's
do; the numpy codec stays as ``_serialize_plain`` / ``_deserialize_plain``,
the plain version the tests hold the native one to, and nothing on a
serving path calls it.
"""

from __future__ import annotations

import struct

import numpy as np

from pilosa_tpu_torch.store import native

MAGIC = 12348
VERSION = 0

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

ARRAY_MAX = 4096  # array container cardinality bound (standard roaring)

# standard-format cookies
COOKIE_NO_RUN = 12346
COOKIE_RUN = 12347
NO_OFFSET_THRESHOLD = 4


# ---------------------------------------------------------------------------
# container assembly from sorted low-16 values
# ---------------------------------------------------------------------------


def _runs_of(lows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lasts) of maximal consecutive runs in sorted uint16 array."""
    breaks = np.nonzero(np.diff(lows.astype(np.int64)) != 1)[0]
    starts = lows[np.concatenate(([0], breaks + 1))]
    lasts = lows[np.concatenate((breaks, [len(lows) - 1]))]
    return starts, lasts


def _best_container(lows: np.ndarray) -> tuple[int, object]:
    """Pick the smallest encoding for one container's sorted values.

    Returns (type, payload) where payload is the values array, a packed
    bitmap uint64[1024], or (starts, lasts).
    """
    n = len(lows)
    starts, lasts = _runs_of(lows)
    run_bytes = 2 + 4 * len(starts)
    array_bytes = 2 * n
    if run_bytes < min(array_bytes, 8192):
        return TYPE_RUN, (starts, lasts)
    if n <= ARRAY_MAX:
        return TYPE_ARRAY, lows
    bits = np.zeros(65536, dtype=np.uint8)
    bits[lows] = 1
    words = np.packbits(bits, bitorder="little").view(np.uint64)
    return TYPE_BITMAP, words


def _expand_bitmap(words8192: bytes) -> np.ndarray:
    if len(words8192) < 8192:
        raise ValueError(
            f"roaring: bitmap container truncated ({len(words8192)} < 8192 "
            "bytes)")
    buf = np.frombuffer(words8192, dtype=np.uint8)
    return np.nonzero(np.unpackbits(buf, bitorder="little"))[0].astype(np.uint16)


def _check_runs(starts: np.ndarray, lasts: np.ndarray) -> None:
    """Reject malformed run lists (untrusted input: imports, cluster
    merges, snapshot files).  Runs must be non-empty intervals, strictly
    ascending and non-overlapping — the same rule the native codec
    enforces (native/roaring_codec.cpp expand_container), which also
    bounds the expansion at 65536 values."""
    s = starts.astype(np.int64)
    e = lasts.astype(np.int64)
    if np.any(e < s) or np.any(s[1:] <= e[:-1]):
        raise ValueError("roaring: malformed run container "
                         "(runs must be ascending, non-overlapping)")


def _expand_runs(starts: np.ndarray, lasts: np.ndarray) -> np.ndarray:
    lens = lasts.astype(np.int64) - starts.astype(np.int64) + 1
    total = int(lens.sum())
    # vectorized multi-arange: offsets within concatenated runs
    idx = np.arange(total, dtype=np.int64)
    run_id = np.repeat(np.arange(len(starts), dtype=np.int64), lens)
    run_base = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return (starts.astype(np.int64)[run_id] + (idx - run_base[run_id])).astype(np.uint16)


def _group_by_high(positions: np.ndarray, shift: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Split sorted positions into per-container low-16 arrays.

    Returns (keys, [lows...]) with keys = unique ``positions >> shift``.
    """
    highs = positions >> np.uint64(shift)
    keys, starts = np.unique(highs, return_index=True)
    bounds = np.append(starts, len(positions))
    lows = [
        (positions[bounds[i]:bounds[i + 1]] & np.uint64(0xFFFF)).astype(np.uint16)
        for i in range(len(keys))
    ]
    return keys, lows


# ---------------------------------------------------------------------------
# pilosa 64-bit format
# ---------------------------------------------------------------------------


def serialize(positions: np.ndarray) -> bytes:
    """Sorted-or-not uint64 bit positions -> pilosa-format bytes, through
    the native codec.  The same bytes as
    ``pilosa_tpu.store.roaring.serialize``."""
    positions = np.asarray(positions, dtype=np.uint64)
    if len(positions) > 1 and not (positions[1:] > positions[:-1]).all():
        positions = np.unique(positions)
    return native.serialize(positions)


def _serialize_plain(positions: np.ndarray) -> bytes:
    """:func:`serialize` in numpy: the plain version."""
    positions = np.unique(np.asarray(positions, dtype=np.uint64))
    keys, lows_per = _group_by_high(positions, 16)
    n = len(keys)
    out = bytearray()
    out += struct.pack("<HHI", MAGIC, VERSION, n)
    payloads: list[bytes] = []
    meta: list[tuple[int, int, int]] = []  # key, type, cardinality
    for key, lows in zip(keys, lows_per):
        ctype, payload = _best_container(lows)
        if ctype == TYPE_ARRAY:
            data = payload.astype("<u2").tobytes()
        elif ctype == TYPE_BITMAP:
            data = payload.astype("<u8").tobytes()
        else:
            starts, lasts = payload
            data = struct.pack("<H", len(starts)) + np.column_stack(
                (starts, lasts)
            ).astype("<u2").tobytes()
        payloads.append(data)
        meta.append((int(key), ctype, len(lows)))
    for key, ctype, card in meta:
        out += struct.pack("<QHH", key, ctype, card - 1)
    data_start = len(out) + 4 * n
    off = data_start
    for data in payloads:
        out += struct.pack("<I", off)
        off += len(data)
    for data in payloads:
        out += data
    return bytes(out)


def serialize_dense(words: np.ndarray, row_ids: np.ndarray | None = None
                    ) -> bytes:
    """Packed row words -> pilosa-format bytes, fully vectorized.

    ``words`` is ``uint32[R, W]`` (row-major packed bits, W*32 = shard
    width); ``row_ids`` the global row id per slab row (default 0..R-1).
    Every non-empty 65536-bit block is written as a BITMAP container —
    valid format but not minimal for sparse/runny blocks (use
    :func:`serialize` for minimality).  This is the bulk writer for
    dense synthetic/bench indexes: no per-position work, essentially a
    popcount + memory-layout transform (reference:
    ``roaring/roaring.go#WriteTo``)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    r, w = words.shape
    cw = 65536 // 32                      # uint32 words per container
    if w % cw:
        raise ValueError(f"roaring: row width {w * 32} not a multiple "
                         "of 65536 bits")
    per_row = w // cw
    if row_ids is None:
        row_ids = np.arange(r, dtype=np.uint64)
    conts = words.reshape(r * per_row, cw)
    cards = np.bitwise_count(conts).sum(axis=1, dtype=np.int64)
    keys = (np.repeat(np.asarray(row_ids, np.uint64), per_row)
            * np.uint64(per_row)
            + np.tile(np.arange(per_row, dtype=np.uint64), r))
    nz = cards > 0
    conts, cards, keys = conts[nz], cards[nz], keys[nz]
    n = len(keys)
    meta = np.zeros(n, dtype=[("k", "<u8"), ("t", "<u2"), ("c", "<u2")])
    meta["k"] = keys
    meta["t"] = TYPE_BITMAP
    meta["c"] = cards - 1                 # stored as cardinality-1
    data_start = 8 + 12 * n + 4 * n
    if data_start + 8192 * n > 0xFFFFFFFF:
        # the format's offsets are uint32: fail loudly like serialize()
        # does, never wrap silently into a corrupt-but-parseable blob
        raise ValueError(
            f"roaring: blob exceeds the 4 GB format limit ({n} bitmap "
            "containers)")
    offsets = (data_start
               + 8192 * np.arange(n, dtype=np.int64)).astype("<u4")
    return (struct.pack("<HHI", MAGIC, VERSION, n) + meta.tobytes()
            + offsets.tobytes() + conts.astype("<u4").tobytes())


def deserialize(buf: bytes | memoryview) -> np.ndarray:
    """Pilosa-format or standard-32-bit bytes -> sorted uint64 positions;
    the pilosa format through the native codec."""
    return _deserialize(buf, native.deserialize)


def _deserialize_plain(buf: bytes | memoryview) -> np.ndarray:
    """:func:`deserialize` in numpy: the plain version."""
    return _deserialize(buf, _deserialize_pilosa)


def _deserialize(buf, pilosa) -> np.ndarray:
    buf = memoryview(buf)
    if len(buf) < 4:
        raise ValueError("roaring: buffer too short")
    magic, = struct.unpack_from("<H", buf, 0)
    if magic == MAGIC:
        return pilosa(buf)
    cookie, = struct.unpack_from("<I", buf, 0)
    if cookie == COOKIE_NO_RUN or (cookie & 0xFFFF) == COOKIE_RUN:
        return read_standard32(buf).astype(np.uint64)
    raise ValueError(f"roaring: unknown magic/cookie {magic}/{cookie}")


def _deserialize_pilosa(buf: memoryview) -> np.ndarray:
    magic, version, n = struct.unpack_from("<HHI", buf, 0)
    if version != VERSION:
        raise ValueError(f"roaring: unsupported version {version}")
    pos = 8
    keys = np.empty(n, dtype=np.uint64)
    types = np.empty(n, dtype=np.uint16)
    cards = np.empty(n, dtype=np.int64)
    for i in range(n):
        k, t, c = struct.unpack_from("<QHH", buf, pos)
        keys[i], types[i], cards[i] = k, t, c + 1
        pos += 12
    offsets = np.frombuffer(buf, dtype="<u4", count=n, offset=pos).astype(np.int64)
    parts: list[np.ndarray] = []
    for i in range(n):
        off = int(offsets[i])
        if types[i] == TYPE_ARRAY:
            lows = np.frombuffer(buf, dtype="<u2", count=int(cards[i]), offset=off)
        elif types[i] == TYPE_BITMAP:
            lows = _expand_bitmap(bytes(buf[off:off + 8192]))
        elif types[i] == TYPE_RUN:
            nr, = struct.unpack_from("<H", buf, off)
            pairs = np.frombuffer(buf, dtype="<u2", count=2 * nr, offset=off + 2)
            _check_runs(pairs[0::2], pairs[1::2])
            lows = _expand_runs(pairs[0::2], pairs[1::2])
        else:
            raise ValueError(f"roaring: bad container type {types[i]}")
        parts.append((keys[i] << np.uint64(16)) | lows.astype(np.uint64))
    if not parts:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# zero-copy directory over a pilosa-format buffer (mmap cold-start path)
# ---------------------------------------------------------------------------


class Directory:
    """Parsed container directory over a pilosa-64 buffer WITHOUT
    expanding any bits — the ``roaring.FromBuffer`` analogue (reference:
    ``syswrap`` mmap open, SURVEY.md §3.1).  Holds only O(containers)
    header arrays; per-row expansion is on demand.  The buffer (usually
    an mmap) must outlive the directory."""

    ROW_SHIFT = 4  # key = position >> 16; row = position >> 20 = key >> 4

    def __init__(self, buf):
        self.buf = memoryview(buf)
        if len(self.buf) < 8:
            raise ValueError("roaring: buffer too short")
        magic, version, n = struct.unpack_from("<HHI", self.buf, 0)
        if magic != MAGIC:
            raise ValueError(f"roaring: bad magic {magic}")
        if version != VERSION:
            raise ValueError(f"roaring: unsupported version {version}")
        hdr_end = 8 + 12 * n
        if len(self.buf) < hdr_end + 4 * n:
            raise ValueError("roaring: truncated container headers")
        hdr = np.frombuffer(self.buf, dtype=np.uint8, count=12 * n,
                            offset=8).reshape(n, 12)
        self.keys = hdr[:, 0:8].copy().view("<u8").reshape(n)
        self.types = hdr[:, 8:10].copy().view("<u2").reshape(n)
        self.cards = (hdr[:, 10:12].copy().view("<u2").reshape(n)
                      .astype(np.int64) + 1)
        self.offsets = np.frombuffer(self.buf, dtype="<u4", count=n,
                                     offset=hdr_end).astype(np.int64)
        # bounds-check every container's payload now, VECTORIZED — a
        # sparse 5M-row snapshot legitimately has tens of millions of
        # tiny containers, so corruption checks cannot be a Python loop
        size = len(self.buf)
        t, off, cards = self.types, self.offsets, self.cards
        known = (t == TYPE_ARRAY) | (t == TYPE_BITMAP) | (t == TYPE_RUN)
        if not known.all():
            bad = int(t[~known][0])
            raise ValueError(f"roaring: bad container type {bad}")
        end = np.where(t == TYPE_ARRAY, off + 2 * cards, off + 8192)
        run_idx = np.nonzero(t == TYPE_RUN)[0]
        if len(run_idx):
            ro = off[run_idx]
            if int(ro.max()) + 2 > size:
                raise ValueError("roaring: truncated run container")
            u8 = np.frombuffer(self.buf, dtype=np.uint8)
            nr = u8[ro].astype(np.int64) | (u8[ro + 1].astype(np.int64)
                                            << 8)
            end[run_idx] = ro + 2 + 4 * nr
        if len(end) and int(end.max()) > size:
            raise ValueError("roaring: container data out of bounds")
        self._rows = (self.keys >> np.uint64(self.ROW_SHIFT)).astype(
            np.uint64)
        # keys ascend in every writer we know; a sorted row axis turns
        # per-row container lookup into searchsorted
        self._rows_sorted = bool(np.all(self._rows[1:] >= self._rows[:-1])) \
            if n > 1 else True
        self._keys_sorted = bool(np.all(self.keys[1:] > self.keys[:-1])) \
            if n > 1 else True

    def row_ids(self) -> np.ndarray:
        return np.unique(self._rows)

    def _row_container_idx(self, row: int) -> np.ndarray:
        if self._rows_sorted:
            lo = np.searchsorted(self._rows, np.uint64(row), "left")
            hi = np.searchsorted(self._rows, np.uint64(row), "right")
            return np.arange(lo, hi)
        return np.nonzero(self._rows == np.uint64(row))[0]

    def expand_container(self, i: int) -> np.ndarray:
        """Container i's low-16 values, sorted uint16."""
        off, t = int(self.offsets[i]), int(self.types[i])
        if t == TYPE_ARRAY:
            return np.frombuffer(self.buf, dtype="<u2",
                                 count=int(self.cards[i]), offset=off)
        if t == TYPE_BITMAP:
            return _expand_bitmap(bytes(self.buf[off:off + 8192]))
        nr, = struct.unpack_from("<H", self.buf, off)
        pairs = np.frombuffer(self.buf, dtype="<u2", count=2 * nr,
                              offset=off + 2)
        _check_runs(pairs[0::2], pairs[1::2])
        return _expand_runs(pairs[0::2], pairs[1::2])

    def row_has_bitmap(self, row: int) -> bool:
        """Whether any of one row's containers is a bitmap container."""
        return bool((self.types[self._row_container_idx(row)]
                     == TYPE_BITMAP).any())

    def row_cardinality(self, row: int) -> int:
        """One row's set-bit count, from the container headers alone."""
        return int(self.cards[self._row_container_idx(row)].sum())

    def row_cards(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ids uint64[R] sorted, cardinalities int64[R]) of every row,
        summed from the container headers with no bit expanded.  Cached:
        the buffer is immutable."""
        cached = getattr(self, "_row_cards_cache", None)
        if cached is None:
            uniq, inv = np.unique(self._rows, return_inverse=True)
            cards = np.zeros(len(uniq), np.int64)
            np.add.at(cards, inv, self.cards)
            cached = self._row_cards_cache = (uniq, cards)
        return cached

    def row_words(self, row: int, out: np.ndarray) -> None:
        """OR one row's bits into ``out`` (uint32[32768], the row's
        packed words) straight from the blob: bitmap containers are a
        plain memcpy of their 8KB payload — no position expansion, no
        repacking.  The fast path for assembling device planes from
        mmap'd snapshots (array/run containers scatter their bits)."""
        for i in self._row_container_idx(row):
            i = int(i)
            base_word = (int(self.keys[i])
                         & ((1 << self.ROW_SHIFT) - 1)) * 2048
            if int(self.types[i]) == TYPE_BITMAP:
                off = int(self.offsets[i])
                out[base_word:base_word + 2048] |= np.frombuffer(
                    self.buf, dtype="<u4", count=2048, offset=off)
            else:
                lows = self.expand_container(i).astype(np.int32)
                np.bitwise_or.at(
                    out, base_word + (lows >> 5),
                    (np.uint32(1) << (lows & 31).astype(np.uint32)))

    def contains(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """bool[len(rows), len(cols)]: whether each row holds each column
        offset (uint32), probed in the containers those columns fall in
        with nothing expanded: one search of the container keys for every
        (row, column), a bit test in a bitmap container's bytes, a search
        in an array or run container."""
        rows = np.asarray(rows, np.uint64)
        cols = np.asarray(cols, np.uint32)
        keys = ((rows[:, None] << np.uint64(self.ROW_SHIFT))
                | (cols >> np.uint32(16)).astype(np.uint64)[None, :])
        lows = np.broadcast_to((cols & np.uint32(0xFFFF)).astype(np.int64),
                               keys.shape).ravel()
        keys = keys.ravel()
        out = np.zeros(len(keys), bool)
        if not len(self.keys) or not len(keys):
            return out.reshape(len(rows), len(cols))
        order = (None if self._keys_sorted
                 else np.argsort(self.keys, kind="stable"))
        skeys = self.keys if order is None else self.keys[order]
        at = np.minimum(np.searchsorted(skeys, keys), len(skeys) - 1)
        found = skeys[at] == keys
        ci = at if order is None else order[at]
        types = self.types[ci]
        bitmap = found & (types == TYPE_BITMAP)
        u8 = np.frombuffer(self.buf, dtype=np.uint8)
        byte = u8[np.where(bitmap, self.offsets[ci] + (lows >> 3), 0)]
        out[bitmap] = ((byte >> (lows & 7)) & 1)[bitmap] != 0
        for p in np.flatnonzero(found & ~bitmap).tolist():
            i, low = int(ci[p]), int(lows[p])
            off = int(self.offsets[i])
            if int(types[p]) == TYPE_ARRAY:
                vals = np.frombuffer(self.buf, dtype="<u2",
                                     count=int(self.cards[i]), offset=off)
                k = int(np.searchsorted(vals, low))
                out[p] = k < len(vals) and int(vals[k]) == low
                continue
            nr, = struct.unpack_from("<H", self.buf, off)
            pairs = np.frombuffer(self.buf, dtype="<u2", count=2 * nr,
                                  offset=off + 2)
            k = int(np.searchsorted(pairs[0::2], low, "right")) - 1
            out[p] = k >= 0 and low <= int(pairs[2 * k + 1])
        return out.reshape(len(rows), len(cols))

    def expand_row(self, row: int) -> np.ndarray:
        """One row's column offsets (sorted uint32) — touches only that
        row's containers."""
        idx = self._row_container_idx(row)
        parts = []
        for i in idx:
            base = (int(self.keys[i]) & ((1 << self.ROW_SHIFT) - 1)) << 16
            parts.append(self.expand_container(int(i)).astype(np.uint32)
                         | np.uint32(base))
        if not parts:
            return np.empty(0, np.uint32)
        return np.concatenate(parts)


# ---------------------------------------------------------------------------
# standard 32-bit roaring (public spec)
# ---------------------------------------------------------------------------


def read_standard32(buf: bytes | memoryview) -> np.ndarray:
    """Standard roaring format bytes -> sorted uint32 values (as uint64)."""
    buf = memoryview(buf)
    cookie, = struct.unpack_from("<I", buf, 0)
    pos = 4
    run_flags = None
    if cookie == COOKIE_NO_RUN:
        n, = struct.unpack_from("<I", buf, pos)
        pos += 4
    elif (cookie & 0xFFFF) == COOKIE_RUN:
        n = (cookie >> 16) + 1
        nb = (n + 7) // 8
        run_flags = np.frombuffer(buf, dtype=np.uint8, count=nb, offset=pos)
        pos += nb
    else:
        raise ValueError(f"standard32: bad cookie {cookie}")
    keys = np.empty(n, dtype=np.uint64)
    cards = np.empty(n, dtype=np.int64)
    for i in range(n):
        k, c = struct.unpack_from("<HH", buf, pos)
        keys[i], cards[i] = k, c + 1
        pos += 4
    if run_flags is None or n >= NO_OFFSET_THRESHOLD:
        pos += 4 * n  # skip offset header; data is sequential anyway
    parts = []
    for i in range(n):
        is_run = run_flags is not None and (run_flags[i // 8] >> (i % 8)) & 1
        if is_run:
            nr, = struct.unpack_from("<H", buf, pos)
            pos += 2
            pairs = np.frombuffer(buf, dtype="<u2", count=2 * nr, offset=pos)
            pos += 4 * nr
            starts = pairs[0::2]
            lasts64 = pairs[0::2].astype(np.int64) + pairs[1::2]
            if np.any(lasts64 > 0xFFFF):
                raise ValueError("standard32: run exceeds container range")
            lasts = lasts64.astype(np.uint16)
            _check_runs(starts, lasts)
            lows = _expand_runs(starts, lasts)
        elif cards[i] > ARRAY_MAX:
            lows = _expand_bitmap(bytes(buf[pos:pos + 8192]))
            pos += 8192
        else:
            lows = np.frombuffer(buf, dtype="<u2", count=int(cards[i]), offset=pos)
            pos += 2 * int(cards[i])
        parts.append((keys[i] << np.uint64(16)) | lows.astype(np.uint64))
    if not parts:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(parts)
