"""GroupBy: every combination's count, and an aggregate per group.

The counterpart of ``pilosa_tpu.exec.groupby``.  ``GroupBy(Rows(a),
Rows(b), ..., Rows(z))`` counts the columns of every combination of the
levels' rows.  All levels but the innermost are *prefix* levels: each
combination ANDs one row of each (and the ``filter=`` words) into a
prefix ``int32[S, W]``, and the innermost level is counted whole by one
``row_counts`` launch over its rows plane filtered by that prefix.  The
reference runs the combinations as one XLA program (``lax.map`` in
batches of 32); PyTorch runs eagerly, so here they are a loop over the
block's combinations, every popcount through the hand kernels of
:mod:`pilosa_tpu_torch.engine.kernels`.

Aggregates (``aggregate=Sum/Min/Max(field=f)``) use the BSI functions of
:mod:`pilosa_tpu_torch.engine.bsi` per innermost row: Sum's bit counts
are two filtered ``row_counts`` passes over the bit plane per row, and
the Min/Max descent runs over a chunk of innermost rows at a time with
the bit plane broadcast along the rows (never copied).  Each chunk's
temporaries stay under ``AGG_CHUNK_BYTES``.  A ``BsiOverlay`` on the bit
plane splits each side as the flat aggregates do: the touched word
columns are masked out of the base pass and answered by the merged mini
plane.

The shard axis is reduced on the device in int32, exact up to
``MAX_SHARDS`` shards; the executor refuses more.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.ingest.delta import bsi_excl_filter, bsi_mini_plane
from pilosa_tpu_torch.parallel.mesh import Blocked, drive, run_steps

# per-shard per-bit counts are <= 2^20, so int32 shard-axis sums stay
# exact for up to 2047 shards
MAX_SHARDS = kernels.SAFE_SHARD_SUM

# the Min/Max path reconstructs a signed value in int32 from its bit
# flags; deeper fields take the executor's exact host path
MINMAX_MAX_DEPTH = 30

# device output of one combination block: a huge tree streams in blocks
BLOCK_OUT_BYTES = 64 << 20
# smaller blocks when a limit= may stop the stream after a few groups
LIMIT_BLOCK = 1024

# innermost rows per aggregate step: the combination's words of these
# rows and the Min/Max descent's temporaries stay under this size
AGG_CHUNK_BYTES = 512 << 20

_I32 = torch.int32
_BIG = 2**31 - 1  # the empty-cell sentinel of the Min/Max reduce


def _prefix(prefix_planes, ix, filter_words):
    """One combination's prefix words int32[S, W] (None: no prefix
    level and no filter)."""
    prefix = filter_words
    for lvl, plane in enumerate(prefix_planes):
        row = plane[:, int(ix[lvl]), :]
        prefix = row if prefix is None else prefix & row
    return None if prefix is None else prefix.contiguous()


def _mini_words(last_plane, prefix, delta):
    """The mini side's filter words int32[K, n_last]: the combination's
    words of every innermost row gathered at the overlay's touched
    columns BEFORE the base side's exclusion (which zeroes exactly these),
    zero on pad lanes."""
    s = last_plane.shape[0]
    cs = delta.col_shard.long()
    cw = delta.col_word.long()
    ok = (cs < s)[:, None]
    cs_c = cs.clamp(0, s - 1)
    w = last_plane[cs_c, :, cw]                       # [K, n_last]
    if prefix is not None:
        w = w & prefix[cs_c, cw][:, None]
    return torch.where(ok, w, torch.zeros_like(w))


def _mini_rows(mini: torch.Tensor, n: int) -> torch.Tensor:
    """The mini plane int32[K, R, 1] once per innermost row, as one
    contiguous [K * n, R, 1] plane (a few MB: K <= the overlay's
    columns).  A reshaped ``expand`` stayed a stride-0 view for K = 1,
    which the ``row_counts`` kernel refuses."""
    return mini.repeat_interleave(n, dim=0)


def _row_words(last_plane, i0: int, i1: int, prefix, excl):
    """The base side's words of innermost rows [i0, i1): int32[S, i1-i0,
    W] (a view without prefix and overlay), the prefix and the overlay
    exclusion applied."""
    w = last_plane[:, i0:i1, :]
    if prefix is not None:
        w = w & prefix[:, None, :]
    if excl is not None:
        w = w & excl[:, None, :]
    return w


def _signed(bits: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Signed int32 values from bit flags [..., depth] (depth <= 30)."""
    depth = bits.shape[-1]
    weights = torch.ones(depth, dtype=_I32, device=bits.device) << \
        torch.arange(depth, dtype=_I32, device=bits.device)
    v = (bits.to(_I32) * weights).sum(-1, dtype=_I32)
    return torch.where(neg, -v, v)


def _reduce_min_max(mm: dict) -> dict:
    """Per-shard (and per mini column) flags [E, n, ...] -> the group's
    min, max and their counts int32[n], empty cells at the sentinels."""
    mn = torch.where(mm["min_cnt"] > 0,
                     _signed(mm["min_bits"], mm["min_neg"]), _BIG)
    mx = torch.where(mm["max_cnt"] > 0,
                     _signed(mm["max_bits"], mm["max_neg"]), -_BIG)
    gmn, gmx = mn.min(0).values, mx.max(0).values
    zero = torch.zeros_like(mm["min_cnt"])
    return {"min": gmn,
            "min_cnt": torch.where(mn == gmn[None], mm["min_cnt"],
                                   zero).sum(0, dtype=_I32),
            "max": gmx,
            "max_cnt": torch.where(mx == gmx[None], mm["max_cnt"],
                                   zero).sum(0, dtype=_I32)}


def _agg_sum(last_plane, prefix, agg_plane, excl, mini, delta) -> dict:
    """Sum's per-bit positive and negative counts and non-null counts of
    every innermost row of one combination: per row, the two filtered
    ``row_counts`` passes of ``bsi.bit_counts`` over the bit plane."""
    n = last_plane.shape[1]
    pos, neg, cnt = [], [], []
    for i in range(n):
        words = last_plane[:, i, :]
        if prefix is not None:
            words = words & prefix
        if excl is not None:
            words = words & excl
        p, q, c = bsik.bit_counts(agg_plane, words.contiguous())
        pos.append(p.sum(0, dtype=_I32))
        neg.append(q.sum(0, dtype=_I32))
        cnt.append(c.sum(dtype=_I32))
    out = {"pos": torch.stack(pos), "neg": torch.stack(neg),
           "cnt": torch.stack(cnt)}
    if mini is not None:
        wm = _mini_words(last_plane, prefix, delta)    # [K, n]
        k = wm.shape[0]
        p, q, c = bsik.bit_counts(_mini_rows(mini, n), wm.reshape(k * n, 1))
        out["pos"] = out["pos"] + p.reshape(k, n, -1).sum(0, dtype=_I32)
        out["neg"] = out["neg"] + q.reshape(k, n, -1).sum(0, dtype=_I32)
        out["cnt"] = out["cnt"] + c.reshape(k, n).sum(0, dtype=_I32)
    return out


def _agg_min_max(last_plane, prefix, agg_plane, excl, mini,
                 delta) -> dict:
    """The min, max and their counts of every innermost row of one
    combination: the descent of ``bsi.min_max_steps`` over as many rows at
    a time as ``AGG_CHUNK_BYTES`` allows, the bit plane broadcast along
    them (a step generator, as that descent is)."""
    s, n, w = last_plane.shape
    chunk = max(1, AGG_CHUNK_BYTES // max(1, s * w * 4))
    aplane = agg_plane[:, None]                  # [S, 1, D + 2, W], a view
    mini_mm = None
    if mini is not None:
        wm = _mini_words(last_plane, prefix, delta)
        k = wm.shape[0]
        mini_mm = {key: v.reshape(k, n, *v.shape[1:]) for key, v in
                   bsik.min_max_bits(_mini_rows(mini, n),
                                     wm.reshape(k * n, 1)).items()}
    parts = []
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        mm = yield from bsik.min_max_steps(
            aplane, _row_words(last_plane, i0, i1, prefix, excl))
        if mini_mm is not None:
            # the touched columns append as pseudo-shard entries; the
            # sentinel reduce over axis 0 combines base and mini exactly
            mm = {key: torch.cat([v, mini_mm[key][:, i0:i1]])
                  for key, v in mm.items()}
        parts.append(_reduce_min_max(mm))
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def groupby_out(prefix_planes: tuple, combo_idx: np.ndarray,
                last_plane: torch.Tensor, filter_words, agg_plane,
                agg: str | None, agg_delta=None) -> dict:
    """Every combination's counts (and aggregate parts) of one block
    (:func:`groupby_steps` run over whole shards)."""
    return drive(groupby_steps(prefix_planes, combo_idx, last_plane,
                               filter_words, agg_plane, agg, agg_delta))


def groupby_steps(prefix_planes: tuple, combo_idx: np.ndarray,
                  last_plane: torch.Tensor, filter_words, agg_plane,
                  agg: str | None, agg_delta=None):
    """Every combination's counts (and aggregate parts) of one block, as
    a step generator (``parallel.mesh.run_steps``: the Min/Max descent's
    per-shard counts are yielded).

    ``prefix_planes``: one int32[S, n_l, W] rows plane per prefix level
    (possibly none); ``combo_idx``: host int32[C, L-1], one row slot per
    prefix level per combination; ``last_plane``: the innermost level's
    int32[S, n_last, W]; ``filter_words``: int32[S, W] or None;
    ``agg_plane``: the BSI bit plane int32[S, D+2, W] or None; ``agg``:
    None, "sum" or "minmax"; ``agg_delta``: the bit plane's
    ``BsiOverlay`` or None.

    Returns int32 tensors on the device, C = 1 without prefix levels:
    counts [C, n_last]; Sum adds pos/neg [C, n_last, D] and cnt [C,
    n_last]; Min/Max adds min, min_cnt, max, max_cnt [C, n_last] (an
    empty cell has count 0 and the sentinel value)."""
    excl = mini = None
    if agg is not None and agg_delta is not None:
        excl = bsi_excl_filter(agg_plane, agg_delta.col_shard,
                               agg_delta.col_word, None, agg_delta.n)
        mini = bsi_mini_plane(agg_plane, agg_delta.col_shard,
                              agg_delta.col_word, agg_delta.col_vals,
                              agg_delta.col_mask)
    combos = combo_idx if prefix_planes else np.zeros((1, 0), np.int32)
    outs = []
    for ix in combos:
        prefix = _prefix(prefix_planes, ix, filter_words)
        out = {"counts": kernels.row_counts(last_plane, prefix)
               .sum(0, dtype=_I32)}
        if agg == "sum":
            out.update(_agg_sum(last_plane, prefix, agg_plane, excl, mini,
                                agg_delta))
        elif agg == "minmax":
            out.update((yield from _agg_min_max(
                last_plane, prefix, agg_plane, excl, mini, agg_delta)))
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


def groupby_out_any(prefix_planes: tuple, combo_idx: np.ndarray,
                    last_plane, filter_words, agg_plane, agg: str | None,
                    agg_delta=None) -> dict:
    """:func:`groupby_out` over plain or blocked planes: per block under
    a placement, each block's per-combination parts combined on the first
    device (counts and Sum parts add; Min/Max take the extreme and add the
    counts of the blocks that reach it, the sentinel reduce: over word
    blocks each block's count is its part of a shard's)."""
    if not isinstance(last_plane, Blocked):
        return groupby_out(prefix_planes, combo_idx, last_plane,
                           filter_words, agg_plane, agg, agg_delta)
    outs = run_steps(last_plane, groupby_steps, prefix_planes, combo_idx,
                     last_plane, filter_words, agg_plane, agg, agg_delta)
    out = {k: last_plane.total([o[k] for o in outs])
           for k in ("counts", "pos", "neg", "cnt") if k in outs[0]}
    if agg == "minmax":
        mm = {k: torch.stack([last_plane.to_first(o[k]) for o in outs])
              for k in ("min", "min_cnt", "max", "max_cnt")}
        gmn, gmx = mm["min"].min(0).values, mm["max"].max(0).values
        zero = torch.zeros_like(mm["min_cnt"])
        out.update(
            {"min": gmn,
             "min_cnt": torch.where(mm["min"] == gmn[None], mm["min_cnt"],
                                    zero).sum(0, dtype=_I32),
             "max": gmx,
             "max_cnt": torch.where(mm["max"] == gmx[None], mm["max_cnt"],
                                    zero).sum(0, dtype=_I32)})
    return out


def block_part_names(agg: str | None) -> tuple[str, ...]:
    """The part order of one flattened block
    (``FusedCache.run_groupby_batch``'s layout)."""
    if agg == "sum":
        return ("counts", "pos", "neg", "cnt")
    if agg == "minmax":
        return ("counts", "min", "min_cnt", "max", "max_cnt")
    return ("counts",)


def block_shapes(n_combos: int, n_last: int, depth: int,
                 agg: str | None) -> dict[str, tuple]:
    """Per-part shapes of one block's outputs (C = the padded combination
    count; prefix-less GroupBys run C = 1)."""
    c = n_combos
    shapes = {"counts": (c, n_last)}
    if agg == "sum":
        shapes.update(pos=(c, n_last, depth), neg=(c, n_last, depth),
                      cnt=(c, n_last))
    elif agg == "minmax":
        shapes.update({"min": (c, n_last), "min_cnt": (c, n_last),
                       "max": (c, n_last), "max_cnt": (c, n_last)})
    return shapes


def unflatten_block(flat: np.ndarray, n_combos: int, n_last: int,
                    depth: int, agg: str | None) -> dict[str, np.ndarray]:
    """Invert ``run_groupby_batch``'s flatten: one packed int32 read back
    into the per-part arrays."""
    shapes = block_shapes(n_combos, n_last, depth, agg)
    out = {}
    off = 0
    for name in block_part_names(agg):
        shape = shapes[name]
        size = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[off:off + size].reshape(shape)
        off += size
    return out


def combo_grid(levels: list[np.ndarray]) -> np.ndarray:
    """Cartesian product of per-level arrays in lexicographic order,
    [C, L] in the input dtype (row slots int32, or row ids uint64)."""
    if not levels:
        return np.zeros((1, 0), np.int32)
    grids = np.meshgrid(*levels, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def _run_solo(planes, combo_idx, last_plane, filter_words, agg_plane, agg,
              agg_delta) -> dict:
    out = groupby_out_any(planes, combo_idx, last_plane, filter_words,
                          agg_plane, agg, agg_delta)
    return {k: v.cpu().numpy() for k, v in out.items()}


def iter_blocks(specs, filter_words, agg_plane, agg_kind,
                limited: bool = False, run=None, agg_delta=None):
    """Run the combinations in lexicographic blocks.

    ``specs``: [(field, row ids, PlaneSet)], the last one the innermost
    level.  Yields ``(combo row ids uint64[B, L-1], {part: host array})``
    in combination order; a caller stops consuming once a ``limit=`` is
    met.  Blocks pad to one size by repeating their last combination
    (the reference's single compiled shape); the pad is sliced off here.
    ``run``: the block dispatcher (the batcher's ``submit_groupby`` in
    the serving configuration), with :func:`groupby_out`'s arguments,
    returning host arrays; by default one direct call."""
    *prefix_specs, (_, _, last_ps) = specs
    slot_levels = [np.array([ps.slot_of[int(r)] for r in rows], np.int32)
                   for _, rows, ps in prefix_specs]
    row_levels = [np.asarray(rows, np.uint64) for _, rows, _ in prefix_specs]
    combo_slots = combo_grid(slot_levels).astype(np.int32)
    combo_rows = combo_grid(row_levels)
    n_combos = combo_slots.shape[0]

    n_last = last_ps.plane.shape[1]
    per_combo = n_last * 4
    if agg_kind == "sum":
        depth = agg_plane.plane.shape[1] - 2
        per_combo += n_last * (2 * depth + 1) * 4
    elif agg_kind == "minmax":
        per_combo += n_last * 16
    block = max(1, min(n_combos, BLOCK_OUT_BYTES // per_combo,
                       *([LIMIT_BLOCK] if limited else [])))

    planes = tuple(ps.plane for _, _, ps in prefix_specs)
    aplane = agg_plane.plane if agg_plane is not None else None
    run = run or _run_solo
    for start in range(0, n_combos, block):
        sl = combo_slots[start:start + block]
        n = sl.shape[0]
        if n < block:  # pad to the block size; the tail drops below
            sl = np.concatenate([sl, np.repeat(sl[-1:], block - n, axis=0)])
        out = run(planes, sl, last_ps.plane, filter_words, aplane, agg_kind,
                  agg_delta)
        yield (combo_rows[start:start + n],
               {k: np.asarray(v)[:n] for k, v in out.items()})
