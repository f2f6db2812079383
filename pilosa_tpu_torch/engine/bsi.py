"""Bit-sliced integer (BSI) functions: Range, Sum, Min, Max, Distinct and
Percentile over bit planes (``pilosa_tpu.engine.bsi``).

An int field is stored as one row per bit position plus an exists row and
a sign row, and the device keeps that layout as a dense plane:

    plane: int32[S, depth + 2, W]
      plane[:, EXISTS_ROW, :]   not-null bitmap
      plane[:, SIGN_ROW, :]     sign bitmap (1 = negative)
      plane[:, OFFSET_ROW+b, :] bit b of |value - base|

The store never sets SIGN with a zero magnitude: there is no negative
zero.  Words are int32 carrying uint32 bits, so all-ones is ``-1``.

The reference runs these as XLA ``jnp``, not Pallas, so they are plain
PyTorch here, and every popcount goes through the hand kernels of
:mod:`pilosa_tpu_torch.engine.kernels`: :func:`bit_counts` is two
``row_counts`` passes over the plane (filtered by the positive and the
negative columns), and the compare chains, the Min/Max descent and the
Percentile steps are counted by ``count``.

Predicates come in two forms.  From the executor they are host values
(``predicate_masks``' uint32 array and a Python bool): with no program
cache to key, the compare chain branches on each predicate bit on the
host and does only the work that bit needs.  Inside
:func:`percentile_search` they are device tensors derived from the search
bounds, so the whole search runs with no host read per step.

A blocked plane (:class:`~pilosa_tpu_torch.parallel.mesh.Blocked`) runs
per block: comparisons and the Min/Max descent per shard, Distinct's
presence per block ORed on the first device, and each Percentile step's
count summed over the blocks before the bounds move.  The descent is a
step generator (:func:`min_max_steps`): every per-shard count it decides
on is yielded and read back whole, so on a 2-D placement each step sums
over the shard's word blocks before any block moves on.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.parallel.mesh import Blocked, per_block

EXISTS_ROW = 0
SIGN_ROW = 1
OFFSET_ROW = 2

CMP_KEYS = ("lt", "le", "gt", "ge", "eq", "ne")


def depth_of(plane: torch.Tensor) -> int:
    return plane.shape[-2] - OFFSET_ROW


def predicate_masks(magnitude: int, depth: int) -> np.ndarray:
    """Lane-broadcast per-bit masks of ``|p|``: uint32[depth] of
    0x00000000 / 0xFFFFFFFF.  Raises if ``|p|`` does not fit in ``depth``
    bits (truncating would invert comparisons): callers saturate
    out-of-depth predicates first."""
    if magnitude < 0:
        raise ValueError("magnitude must be non-negative")
    if depth < 64 and magnitude >= (1 << depth):
        raise ValueError(f"predicate magnitude {magnitude} exceeds bit "
                         f"depth {depth}")
    return np.array([0xFFFFFFFF if (magnitude >> b) & 1 else 0
                     for b in range(depth)], dtype=np.uint32)


def not_null(plane: torch.Tensor,
             filter_words: torch.Tensor | None = None) -> torch.Tensor:
    exists = plane[..., EXISTS_ROW, :]
    if filter_words is not None:
        exists = exists & filter_words
    return exists


def _signs(plane: torch.Tensor, filter_words):
    """(exists, negative columns, non-negative columns) of the filter."""
    exists = not_null(plane, filter_words)
    sign = plane[..., SIGN_ROW, :] & exists
    return exists, sign, exists & ~sign


def unsigned_cmp(mag: torch.Tensor, pred_masks, universe: torch.Tensor):
    """Columns' magnitude against the predicate magnitude: (lt, eq, gt)
    bitmaps, MSB to LSB.  ``mag`` int32[..., depth, W]; ``universe`` the
    columns under consideration; ``pred_masks`` host masks
    (:func:`predicate_masks`) or an int32[depth] device tensor of 0 / -1.

    Per bit, ``t`` is the still-equal columns that part from the
    predicate here: they join ``lt`` where the predicate bit is 1 and
    ``gt`` where it is 0, and leave ``eq`` (``eq ^ t``)."""
    depth = mag.shape[-2]
    eq = universe
    lt = gt = None
    if isinstance(pred_masks, torch.Tensor):
        lt = torch.zeros_like(universe)
        gt = torch.zeros_like(universe)
        for b in reversed(range(depth)):
            bit, pm = mag[..., b, :], pred_masks[b]
            t = eq & (bit ^ pm)
            lt = lt | (t & pm)
            gt = gt | (t & bit)
            eq = eq ^ t
        return lt, eq, gt
    for b in reversed(range(depth)):
        bit = mag[..., b, :]
        if int(pred_masks[b]):
            t = eq & ~bit
            lt = t if lt is None else lt | t
        else:
            t = eq & bit
            gt = t if gt is None else gt | t
        eq = eq ^ t
    zero = None
    if lt is None or gt is None:
        zero = torch.zeros_like(universe)
    return (zero if lt is None else lt), eq, (zero if gt is None else gt)


@per_block
def range_cmp(plane: torch.Tensor, pred_masks, pred_negative,
              filter_words: torch.Tensor | None = None,
              keys=CMP_KEYS) -> dict:
    """Signed comparisons of stored values against the predicate ``p``:
    ``{key: bitmap}`` for each of ``keys`` ("lt", "le", "gt", "ge", "eq",
    "ne").  ``pred_masks`` encodes ``|p|``; ``pred_negative`` is the sign
    of ``p``, a host bool or a device bool tensor (then every branch is a
    ``torch.where``)."""
    exists, sign, pos = _signs(plane, filter_words)
    m_lt, m_eq, m_gt = unsigned_cmp(plane[..., OFFSET_ROW:, :], pred_masks,
                                    exists)

    def pick(if_neg, if_nonneg):
        if isinstance(pred_negative, torch.Tensor):
            return torch.where(pred_negative, if_neg(), if_nonneg())
        return if_neg() if pred_negative else if_nonneg()

    keys = set(keys)
    out = {}
    eq = pick(lambda: sign & m_eq, lambda: pos & m_eq)
    if keys & {"lt", "le"}:
        # p < 0: v < p <=> v negative with |v| > |p|
        # p >= 0: v < p <=> v negative, or v >= 0 with |v| < |p|
        lt = pick(lambda: sign & m_gt, lambda: sign | (pos & m_lt))
        out["lt"], out["le"] = lt, lt | eq
    if keys & {"gt", "ge"}:
        # p < 0: v > p <=> v >= 0, or v negative with |v| < |p|
        # p >= 0: v > p <=> v >= 0 with |v| > |p|
        gt = pick(lambda: pos | (sign & m_lt), lambda: pos & m_gt)
        out["gt"], out["ge"] = gt, gt | eq
    out["eq"] = eq
    if "ne" in keys:
        out["ne"] = exists & ~eq
    return {k: out[k] for k in CMP_KEYS if k in keys}


def bit_counts(plane: torch.Tensor,
               filter_words: torch.Tensor | None = None):
    """Per-bit positive and negative popcounts and the non-null count,
    int32: (pos[S, depth], neg[S, depth], count[S]).  Two ``row_counts``
    passes over the whole plane, filtered by the non-negative and by the
    negative columns; their exists-row counts add up to the non-null
    count, so no third pass is needed.  :func:`combine_sum` weights the
    bits exactly on the host."""
    _, sign, pos = _signs(plane, filter_words)
    pc = kernels.row_counts(plane, pos)
    nc = kernels.row_counts(plane, sign)
    return (pc[..., OFFSET_ROW:], nc[..., OFFSET_ROW:],
            pc[..., EXISTS_ROW] + nc[..., EXISTS_ROW])


def combine_sum(pos_c, neg_c, cnt) -> tuple[int, int]:
    """Host combine of :func:`bit_counts` over all leading axes: exact
    Python ints (sum of offsets, count)."""
    pos_c = np.asarray(pos_c, dtype=np.int64)
    neg_c = np.asarray(neg_c, dtype=np.int64)
    depth = pos_c.shape[-1]
    flat_p = pos_c.reshape(-1, depth).sum(axis=0)
    flat_n = neg_c.reshape(-1, depth).sum(axis=0)
    total = sum((int(flat_p[b]) - int(flat_n[b])) << b
                for b in range(depth))
    return total, int(np.asarray(cnt, dtype=np.int64).sum())


def _mag_max(cand: torch.Tensor, mag: torch.Tensor):
    """Largest magnitude among candidate columns, per shard: (bits
    bool[S, depth], final candidate bitmap).  The descent picks per shard
    with ``torch.where`` on device booleans: no host read per bit.  A step
    generator: each bit's per-shard count is yielded and read back whole
    (:func:`min_max_steps`)."""
    bits = []
    for b in reversed(range(mag.shape[-2])):
        hit = cand & mag[..., b, :]
        has = (yield kernels.count(hit)) != 0
        cand = torch.where(has[..., None], hit, cand)
        bits.append(has)
    return torch.stack(bits[::-1], dim=-1), cand


def _mag_min(cand: torch.Tensor, mag: torch.Tensor):
    """Smallest magnitude among candidate columns (see :func:`_mag_max`);
    columns that survive a bit only because no zero side existed share
    that bit, so the flags are exact."""
    bits = []
    for b in reversed(range(mag.shape[-2])):
        zero_side = cand & ~mag[..., b, :]
        has_zero = (yield kernels.count(zero_side)) != 0
        cand = torch.where(has_zero[..., None], zero_side, cand)
        bits.append(~has_zero)
    return torch.stack(bits[::-1], dim=-1), cand


def min_max_steps(plane: torch.Tensor,
                  filter_words: torch.Tensor | None = None):
    """Per-shard min and max as device bit flags and counts, host
    reconstruction in :func:`combine_min_max`; a step generator (see
    :func:`~pilosa_tpu_torch.parallel.mesh.run_steps`): the per-shard
    ``count`` of every bitmap the descent decides on is yielded, and the
    count read back is the shard's over its whole words.  The final
    counts stay the block's own: over word blocks each block's entries
    carry its part, and the host combine adds the parts of equal
    values."""
    _, sign, pos = _signs(plane, filter_words)
    mag = plane[..., OFFSET_ROW:, :]
    has_neg = (yield kernels.count(sign)) != 0
    has_pos = (yield kernels.count(pos)) != 0
    live = has_neg | has_pos
    # min: the most negative, else the smallest non-negative
    neg_bits, neg_cand = yield from _mag_max(sign, mag)
    posmin_bits, posmin_cand = yield from _mag_min(pos, mag)
    min_bits = torch.where(has_neg[..., None], neg_bits, posmin_bits)
    min_cand = torch.where(has_neg[..., None], neg_cand, posmin_cand)
    min_cnt = torch.where(live, kernels.count(min_cand), 0)
    # max: the largest non-negative, else the least negative
    posmax_bits, posmax_cand = yield from _mag_max(pos, mag)
    negmin_bits, negmin_cand = yield from _mag_min(sign, mag)
    max_bits = torch.where(has_pos[..., None], posmax_bits, negmin_bits)
    max_cand = torch.where(has_pos[..., None], posmax_cand, negmin_cand)
    max_cnt = torch.where(live, kernels.count(max_cand), 0)
    return {"min_bits": min_bits, "min_neg": has_neg, "min_cnt": min_cnt,
            "max_bits": max_bits, "max_neg": has_neg & ~has_pos,
            "max_cnt": max_cnt}


# per shard (per (shard, word block) on a 2-D placement: entries whose
# counts the host adds), concatenated over the blocks
min_max_bits = per_block(combine="concat", steps=True)(min_max_steps)


def min_max(plane: torch.Tensor,
            filter_words: torch.Tensor | None = None) -> list:
    """Per-shard ``(min, min_count, max, max_count)`` offsets as exact
    Python ints: the device descent of :func:`min_max_bits`, reconstructed
    on the host at any depth."""
    return combine_min_max(min_max_bits(plane, filter_words))


def pack_min_max(mm: dict) -> torch.Tensor:
    """:func:`min_max_bits` as one int32[S, 2*depth+4] tensor (the layout
    :func:`decode_minmax_packed` reads)."""
    i32 = torch.int32
    return torch.cat([mm["min_bits"].to(i32), mm["max_bits"].to(i32),
                      mm["min_neg"].to(i32)[..., None],
                      mm["min_cnt"].to(i32)[..., None],
                      mm["max_neg"].to(i32)[..., None],
                      mm["max_cnt"].to(i32)[..., None]], dim=-1)


def combine_min_max(out: dict) -> list[tuple[int, int, int, int]]:
    """Host reconstruction of :func:`min_max_bits` per shard:
    ``[(min, min_count, max, max_count), ...]`` exact Python ints
    (offsets relative to base; count 0 = no non-null columns)."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    min_bits = host(out["min_bits"])
    max_bits = host(out["max_bits"])
    min_bits = min_bits.reshape(-1, min_bits.shape[-1])
    max_bits = max_bits.reshape(-1, max_bits.shape[-1])
    min_neg = host(out["min_neg"]).reshape(-1)
    max_neg = host(out["max_neg"]).reshape(-1)
    min_cnt = host(out["min_cnt"]).reshape(-1)
    max_cnt = host(out["max_cnt"]).reshape(-1)

    def val(bits) -> int:
        return sum(1 << b for b, hit in enumerate(bits) if hit)

    res = []
    for i in range(len(min_neg)):
        mn = -val(min_bits[i]) if min_neg[i] else val(min_bits[i])
        mx = -val(max_bits[i]) if max_neg[i] else val(max_bits[i])
        res.append((mn, int(min_cnt[i]), mx, int(max_cnt[i])))
    return res


def decode_sum_packed(row: np.ndarray) -> tuple[int, int]:
    """Host decode of one ``run_sum_plane_batch`` item
    (int32[S, 2*depth+1]) -> exact (sum of offsets, count)."""
    depth = (row.shape[-1] - 1) // 2
    return combine_sum(row[:, :depth], row[:, depth:2 * depth], row[:, -1])


def decode_minmax_packed(row: np.ndarray):
    """Host decode of one ``run_minmax_plane_batch`` item
    (int32[S (+ overlay columns), 2*depth+4]) -> per-entry (min, min_cnt,
    max, max_cnt) tuples; the caller drops zero-count entries."""
    depth = (row.shape[-1] - 4) // 2
    return combine_min_max({
        "min_bits": row[:, :depth],
        "max_bits": row[:, depth:2 * depth],
        "min_neg": row[:, 2 * depth].astype(bool),
        "min_cnt": row[:, 2 * depth + 1],
        "max_neg": row[:, 2 * depth + 2].astype(bool),
        "max_cnt": row[:, 2 * depth + 3]})


# ---------------------------------------------------------------------------
# Distinct
# ---------------------------------------------------------------------------

# shards per column-scatter step: a block's decoded values and index
# scratch stay about half a GB whatever the field's size
DISTINCT_BLOCK = 32
# at this depth or less presence is computed per VALUE on packed words;
# deeper fields decode and scatter columns
DISTINCT_VALUE_DEPTH = 10
_DISTINCT_VALUE_BLOCK = 8  # values per step of the value-space scan


def _expand(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> int32[..., W*32] of 0/1, column order LSB first
    (``& 1`` after the arithmetic shift keeps only the wanted bit)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).reshape(*words.shape[:-1], -1)


@per_block(combine="total")
def distinct_presence(plane: torch.Tensor,
                      filter_words: torch.Tensor | None = None):
    """Which offsets occur among the (filtered) columns: (pos bool[2^depth],
    neg bool[2^depth]) for non-negative and negative offsets.  Requires
    ``depth <= 24``; the executor enforces it.

    Deep fields scan ``DISTINCT_BLOCK`` shards per step: decode the
    block's values from the bit rows and scatter into presence arrays of
    ``2^depth + 1`` entries, where columns that do not take part write
    the sentinel slot ``2^depth``, sliced off at the end (torch has no
    dropping scatter).  Blocks' presence arrays add as bools: an OR."""
    depth = depth_of(plane)
    if depth <= DISTINCT_VALUE_DEPTH:
        return _distinct_by_value(plane, filter_words)
    size = 1 << depth
    dev = plane.device
    pos = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    neg = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    for s0 in range(0, plane.shape[0], DISTINCT_BLOCK):
        pl = plane[s0:s0 + DISTINCT_BLOCK]
        fw = None if filter_words is None \
            else filter_words[s0:s0 + DISTINCT_BLOCK]
        exists, sign, _ = _signs(pl, fw)
        values = _expand(pl[:, OFFSET_ROW, :])
        for b in range(1, depth):
            values = values | (_expand(pl[:, OFFSET_ROW + b, :]) << b)
        exists_b = _expand(exists).bool()
        sign_b = _expand(sign).bool()
        sentinel = torch.full_like(values, size)
        pos.index_fill_(0, torch.where(exists_b & ~sign_b, values,
                                       sentinel).reshape(-1).long(), True)
        neg.index_fill_(0, torch.where(exists_b & sign_b, values,
                                       sentinel).reshape(-1).long(), True)
    return pos[:size], neg[:size]


def _distinct_by_value(plane: torch.Tensor, filter_words):
    """Small value spaces: the columns holding magnitude ``v`` are
    ``exists & AND_b (bit_b(v) ? mag_b : ~mag_b)``, on packed words,
    ``_DISTINCT_VALUE_BLOCK`` values per step; presence is whether any
    such word is nonzero, split by sign."""
    depth = depth_of(plane)
    size = 1 << depth
    exists, sign, pos_cols = _signs(plane, filter_words)
    mag = plane[..., OFFSET_ROW:, :]
    vb = min(_DISTINCT_VALUE_BLOCK, size)
    pos, neg = [], []
    for v0 in range(0, size, vb):
        vals = torch.arange(v0, v0 + vb, device=plane.device)
        m = exists.expand((vb,) + tuple(exists.shape))
        for b in range(depth):
            pb = mag[..., b, :]
            bit = ((vals >> b) & 1).bool().reshape(-1, *[1] * pb.dim())
            m = m & torch.where(bit, pb, ~pb)
        pos.append((m & pos_cols).reshape(vb, -1).ne(0).any(1))
        neg.append((m & sign).reshape(vb, -1).ne(0).any(1))
    return torch.cat(pos), torch.cat(neg)


# ---------------------------------------------------------------------------
# Percentile: the whole search on the device, no read per step
# ---------------------------------------------------------------------------


def _count_le(plane: torch.Tensor, filter_words, v: torch.Tensor,
              depth: int) -> torch.Tensor:
    """Columns whose stored offset is <= the device int32 scalar ``v``:
    :func:`range_cmp` with masks and sign derived from ``v`` on the
    device, counted by the ``count`` kernel.  int32 is exact while
    S * 2^20 < 2^31."""
    shifts = torch.arange(depth, dtype=torch.int32, device=v.device)
    masks = torch.where(((v.abs() >> shifts) & 1) != 0, -1, 0).to(
        torch.int32)
    le = range_cmp(plane, masks, v < 0, filter_words, keys=("le",))["le"]
    return kernels.count(le).sum(dtype=torch.int32)


@per_block(combine="total")
def percentile_total(plane: torch.Tensor,
                     filter_words: torch.Tensor | None) -> torch.Tensor:
    """Non-null (filtered) column count, a device int32 scalar: the rank
    universe from which the host computes the exact integer target."""
    return kernels.count(not_null(plane, filter_words)).sum(
        dtype=torch.int32)


def percentile_search(plane: torch.Tensor,
                      filter_words: torch.Tensor | None,
                      target: int) -> torch.Tensor:
    """int32[2] on the device: the smallest stored offset whose count of
    offsets <= it reaches ``target`` (>= 1), and the count at that
    offset.  A binary search over [-(2^depth - 1), 2^depth - 1] with
    ``depth + 1`` fixed steps, the bounds kept on the device (converged
    steps keep both); ``>> 1`` on int32 is arithmetic, the floor for
    negative midpoints."""
    depth = depth_of(plane)
    bound = (1 << depth) - 1
    dev = plane.device
    count_le = _count_le
    if isinstance(plane, Blocked):
        # each step's per-block counts sum on the first device, and the
        # bounds it moves are handed to every block
        def count_le(pl, fw, v, d):
            return pl.total(pl.map(_count_le, pl, fw,
                                   pl.placement.replicate(v), d))
    lo = torch.tensor(-bound, dtype=torch.int32, device=dev)
    hi = torch.tensor(bound, dtype=torch.int32, device=dev)
    for _ in range(depth + 1):
        mid = (lo + hi) >> 1
        reach = count_le(plane, filter_words, mid, depth) >= target
        done = lo >= hi
        lo, hi = (torch.where(done | reach, lo, mid + 1),
                  torch.where(done | ~reach, hi, mid))
    at = count_le(plane, filter_words, lo, depth)
    below = torch.where(lo > -bound,
                        count_le(plane, filter_words, lo - 1, depth), 0)
    return torch.stack([lo, at - below]).to(torch.int32)
