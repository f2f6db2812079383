"""The harness's own roaring encoder: a shard of one set field, where
every column holds exactly one row, or of one int field's bit planes, as
one pilosa-format blob.

The layout (the port's ``store/roaring.py`` documents the same format):
``u16 magic 12348, u16 version 0, u32 container count``, then per
container ``u64 key, u16 type, u16 cardinality - 1``, then per container
a ``u32`` byte offset of its data, then the data: an array container as
sorted ``u16`` lows, a bitmap container as 1024 ``u64`` words, a run
container as a ``u16`` run count and inclusive ``(start, last)`` ``u16``
pairs.  Each container takes the smallest of the three forms, so rows
that arrive in runs (columns in import order) encode as runs.

A set field is encoded from its sorted positions, vectorised over every
container of the shard; an int field from its rows of bits, one
container at a time (a shard's planes hold at most a few hundred).
"""

from __future__ import annotations

import numpy as np

SHARD_WIDTH = 1 << 20
MAGIC = 12348
TYPE_ARRAY, TYPE_BITMAP, TYPE_RUN = 1, 2, 3
ARRAY_MAX = 4096


def positions(rows: np.ndarray) -> np.ndarray:
    """Sorted ``row * SHARD_WIDTH + column`` positions of one shard whose
    column ``i`` holds row ``rows[i]``."""
    rows = np.asarray(rows)
    order = np.argsort(rows, kind="stable")
    return (rows[order].astype(np.uint64) << np.uint64(20)) | \
        order.astype(np.uint64)


def encode_positions(pos: np.ndarray) -> bytes:
    """Sorted unique uint64 positions -> pilosa-format roaring bytes."""
    pos = np.asarray(pos, np.uint64)
    n = len(pos)
    head = np.array([MAGIC, 0], "<u2").tobytes()
    if n == 0:
        return head + np.array([0], "<u4").tobytes()
    keys_all = pos >> np.uint64(16)
    lows = (pos & np.uint64(0xFFFF)).astype(np.int64)
    starts = np.flatnonzero(np.concatenate(([True],
                                            keys_all[1:] != keys_all[:-1])))
    ends = np.append(starts[1:], n)
    keys = keys_all[starts]
    cards = ends - starts
    # a run starts where the low does not follow the previous one within
    # the same container
    brk = np.ones(n, bool)
    brk[1:] = (lows[1:] != lows[:-1] + 1)
    brk[starts] = True
    run_idx = np.flatnonzero(brk)
    n_runs = np.add.reduceat(brk.astype(np.int64), starts)
    size_array = 2 * cards
    size_run = 2 + 4 * n_runs
    ctype = np.where(cards <= ARRAY_MAX, TYPE_ARRAY, TYPE_BITMAP)
    size = np.where(ctype == TYPE_ARRAY, size_array, 8192)
    use_run = size_run < size
    ctype = np.where(use_run, TYPE_RUN, ctype)
    size = np.where(use_run, size_run, size)
    nc = len(keys)
    data_start = 8 + 12 * nc + 4 * nc
    offs = data_start + np.concatenate(([0], np.cumsum(size)[:-1]))
    out = np.zeros(data_start + int(size.sum()), np.uint8)
    meta = np.zeros(nc, dtype=[("k", "<u8"), ("t", "<u2"), ("c", "<u2")])
    meta["k"], meta["t"], meta["c"] = keys, ctype, cards - 1
    out[:8] = np.frombuffer(head + np.array([nc], "<u4").tobytes(), np.uint8)
    out[8:8 + 12 * nc] = np.frombuffer(meta.tobytes(), np.uint8)
    out[8 + 12 * nc:data_start] = np.frombuffer(
        offs.astype("<u4").tobytes(), np.uint8)
    cont = np.repeat(np.arange(nc), cards)        # container of each bit
    rank = np.arange(n) - starts[cont]            # index within it
    # array containers: each low as two bytes at its rank
    a = ctype[cont] == TYPE_ARRAY
    at = offs[cont[a]] + 2 * rank[a]
    out[at] = lows[a] & 0xFF
    out[at + 1] = lows[a] >> 8
    # bitmap containers: OR each bit into its byte (distinct bits of one
    # byte sum to their OR)
    b = ctype[cont] == TYPE_BITMAP
    byte_at = offs[cont[b]] + (lows[b] >> 3)
    vals = np.bincount(byte_at, weights=(1 << (lows[b] & 7)),
                       minlength=len(out))
    sel = np.flatnonzero(vals)
    out[sel] |= vals[sel].astype(np.uint8)
    # run containers: the run count, then each run's (start, last)
    r = np.flatnonzero(use_run)
    out[offs[r]] = n_runs[r] & 0xFF
    out[offs[r] + 1] = n_runs[r] >> 8
    rs = run_idx[use_run[cont[run_idx]]]           # run starts in runs
    rc = cont[rs]
    run_end = np.append(run_idx[1:], n) - 1        # last bit of each run
    re = run_end[use_run[cont[run_idx]]]
    first_run = np.searchsorted(rs, starts[rc])    # first run of its container
    k = np.arange(len(rs)) - first_run
    at = offs[rc] + 2 + 4 * k
    for j, v in enumerate((lows[rs], lows[re])):
        out[at + 2 * j] = v & 0xFF
        out[at + 2 * j + 1] = v >> 8
    return out.tobytes()


def bsi_rows(values: np.ndarray, base: int, depth: int) -> np.ndarray:
    """One shard of an int field in pilosa's BSI layout: row 0 the columns
    that hold a value, row 1 the negative ones, row ``2 + b`` bit ``b`` of
    ``|value - base|``.  Returns bool ``[2 + depth, len(values)]``."""
    off = np.asarray(values, np.int64) - np.int64(base)
    mag = np.abs(off)
    out = np.empty((2 + depth, len(off)), bool)
    out[0] = True
    out[1] = off < 0
    for b in range(depth):
        out[2 + b] = (mag >> b) & 1
    return out


def encode_rows(bits: np.ndarray) -> bytes:
    """bool ``[rows, columns]`` (at most a shard's width of columns) ->
    pilosa-format roaring bytes of the positions ``row * SHARD_WIDTH +
    column`` that are set; each container in the smallest of the three
    forms, as :func:`encode_positions` chooses."""
    rows, width = bits.shape
    full = np.zeros((rows, SHARD_WIDTH), bool)
    full[:, :width] = bits
    c = full.reshape(rows * (SHARD_WIDTH >> 16), 1 << 16)
    cards = np.count_nonzero(c, axis=1)
    n_runs = c[:, 0].astype(np.int64) + np.count_nonzero(
        c[:, 1:] & ~c[:, :-1], axis=1)
    keys = np.flatnonzero(cards)
    metas, datas = [], []
    for k in keys.tolist():
        card, runs = int(cards[k]), int(n_runs[k])
        t, size = ((TYPE_ARRAY, 2 * card) if card <= ARRAY_MAX
                   else (TYPE_BITMAP, 8192))
        if 2 + 4 * runs < size:
            edge = np.flatnonzero(np.diff(c[k].astype(np.int8),
                                          prepend=0, append=0))
            pairs = np.stack([edge[0::2], edge[1::2] - 1], 1)
            data = (np.array([runs], "<u2").tobytes()
                    + pairs.astype("<u2").tobytes())
            t = TYPE_RUN
        elif t == TYPE_ARRAY:
            data = np.flatnonzero(c[k]).astype("<u2").tobytes()
        else:
            data = np.packbits(c[k], bitorder="little").tobytes()
        metas.append((k, t, card - 1))
        datas.append(data)
    nc = len(metas)
    meta = np.array(metas, dtype=[("k", "<u8"), ("t", "<u2"), ("c", "<u2")])
    sizes = np.array([len(d) for d in datas], np.int64)
    offs = 8 + 16 * nc + np.concatenate(([0], np.cumsum(sizes)[:-1]))
    return b"".join([np.array([MAGIC, 0], "<u2").tobytes(),
                     np.array([nc], "<u4").tobytes(), meta.tobytes(),
                     offs.astype("<u4").tobytes(), *datas])


def decode(blob: bytes) -> np.ndarray:
    """The encoder's inverse, for the tests: sorted uint64 positions."""
    buf = memoryview(blob)
    nc = int(np.frombuffer(buf, "<u4", 1, 4)[0])
    meta = np.frombuffer(buf, dtype=[("k", "<u8"), ("t", "<u2"), ("c", "<u2")],
                         count=nc, offset=8)
    offs = np.frombuffer(buf, "<u4", nc, 8 + 12 * nc)
    parts = []
    for (key, t, c), off in zip(meta, offs):
        c, off = int(c) + 1, int(off)
        if t == TYPE_ARRAY:
            lows = np.frombuffer(buf, "<u2", c, off).astype(np.uint64)
        elif t == TYPE_BITMAP:
            bits = np.unpackbits(np.frombuffer(buf, np.uint8, 8192, off),
                                 bitorder="little")
            lows = np.flatnonzero(bits).astype(np.uint64)
        else:
            nr = int(np.frombuffer(buf, "<u2", 1, off)[0])
            pairs = np.frombuffer(buf, "<u2", 2 * nr, off + 2).astype(np.int64)
            lows = np.concatenate([np.arange(s, e + 1) for s, e in
                                   zip(pairs[0::2], pairs[1::2])]
                                  ).astype(np.uint64)
        parts.append((np.uint64(key) << np.uint64(16)) | lows)
    return np.concatenate(parts) if parts else np.zeros(0, np.uint64)
