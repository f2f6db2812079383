"""Planned call trees and the serving families over the hand kernels.

The counterpart of ``pilosa_tpu.exec.fused``: the executor plans a
bitmap call tree into a hashable node structure plus a list of leaf
tensors, and one family call answers a whole batch (one request, or a
whole collection window of the batcher).  PyTorch runs eagerly, so there
is no program cache: each family folds the tree with torch bitwise ops
and calls the popcount kernels of :mod:`pilosa_tpu_torch.engine.kernels`
directly.  The whole-tree families (:meth:`FusedCache.run_tree_counts`,
:meth:`FusedCache.run_tree_words`) fold postfix programs
(:mod:`pilosa_tpu_torch.exec.tree`) over rows of one resident plane.  The
BSI families (:meth:`FusedCache.run_sum_plane_batch`,
:meth:`FusedCache.run_minmax_plane_batch`,
:meth:`FusedCache.run_range_batch`) answer K aggregates over ONE resident
bit plane, base+delta through the split of
:func:`pilosa_tpu_torch.ingest.delta.bsi_sides` when the plane carries a
``BsiOverlay``.  :meth:`FusedCache.run_groupby_batch` runs one GroupBy
combination block (:mod:`pilosa_tpu_torch.exec.groupby`).

Every launch and copy here goes to the current stream; outputs stay on
the device un-read (the batcher packs a window's outputs into one read).

Under a placement the planes and leaves are
:class:`~pilosa_tpu_torch.parallel.mesh.Blocked` and overlays
:class:`~pilosa_tpu_torch.ingest.delta.BlockedOverlay`: each family runs
per block (with the block's own overlay part), and its per-block outputs
combine on the placement's first device by the family's reduction, the
``combine`` of its ``parallel.mesh.per_block`` decorator: totals sum,
per-shard outputs gather in block order, a bitmap stays blocked.
The reduction after that is the single-device one, unchanged.  The Min/Max
descent decides per shard: per block, and on a 2-D placement with every
step's counts summed over a shard's word blocks (``per_block(steps=
True)``); the Percentile search gathers each step's counts and hands the
bounds to every block (``engine.bsi.percentile_search``).  A tree whose
``Limit`` (or, over word blocks, ``Shift``) reads other blocks' bits
folds over the blocked operands instead of per block, that op through
its blocked form (``engine.kernels.crosses_blocks``).

Node encodings (nested tuples):

    ("leaf", i)                                   leaf i: int32[S, W] words
    ("and"|"or"|"andnot"|"xor", (child, ...))     fold left
    ("not", child, i_exists)                      exists & ~child
    ("shift", child, n)                           child's columns + n
"""

from __future__ import annotations

import math

import torch

from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.engine.words import pow2_bucket
from pilosa_tpu_torch.exec import groupby as gb
from pilosa_tpu_torch.ingest.delta import (adjusted_row_counts,
                                           adjusted_selected_counts,
                                           bsi_sides, overlay_gathered_rows,
                                           overlay_row, overlay_time_range)
from pilosa_tpu_torch.parallel.mesh import (Blocked, first_blocked,
                                            gathered, per_block)


class Unfusable(Exception):
    """Raised by planners for shapes the fused path doesn't cover."""

_BINARY = {"and": kernels.intersect, "or": kernels.union,
           "andnot": kernels.difference, "xor": kernels.xor}


def _build(node, leaves):
    kind = node[0]
    if kind == "leaf":
        return leaves[node[1]]
    if kind in _BINARY:
        op = _BINARY[kind]
        acc = _build(node[1][0], leaves)
        for child in node[1][1:]:
            acc = op(acc, _build(child, leaves))
        return acc
    if kind == "not":
        return kernels.complement(_build(node[1], leaves), leaves[node[2]])
    if kind == "shift":
        return kernels.shift(_build(node[1], leaves), node[2])
    raise AssertionError(f"bad node {node!r}")


def shift_leaves(node, offset: int):
    """Re-index a plan tree's leaf references by ``offset`` (to
    concatenate several plans' leaf lists into one batch)."""
    kind = node[0]
    if kind == "leaf":
        return ("leaf", node[1] + offset)
    if kind in _BINARY:
        return (kind, tuple(shift_leaves(c, offset) for c in node[1]))
    if kind == "not":
        return ("not", shift_leaves(node[1], offset), node[2] + offset)
    if kind == "shift":
        return ("shift", shift_leaves(node[1], offset), node[2])
    raise AssertionError(f"bad node {node!r}")


class FusedCache:
    """The serving families of one executor (stateless: PyTorch runs
    eagerly, so there are no programs to cache)."""

    def run(self, node, leaves, want: str):
        """Evaluate a planned tree: ``want`` is "words" (int32[S, W]) or
        "count" (per-shard int32[S])."""
        words = _build(node, leaves)
        return kernels.count(words) if want == "count" else words

    def run_count_batch(self, nodes: tuple, leaves) -> torch.Tensor:
        """K Count trees -> int32[K, n_shards], one count launch each: per
        block, unless a tree shifts across word blocks (then each folds
        over the blocked leaves)."""
        owner = first_blocked(leaves)
        if owner is not None and any(
                kernels.crosses_blocks(kernels.TREE_SHIFT, owner)
                and _shifts(n) for n in nodes):
            return torch.stack([gathered(kernels.count(_build(n, leaves)))
                                for n in nodes])
        return self._count_batch(nodes, leaves)

    @staticmethod
    @per_block(combine="gather", dim=1)
    def _count_batch(nodes: tuple, leaves) -> torch.Tensor:
        return torch.stack([kernels.count(_build(n, leaves))
                            for n in nodes])

    @per_block(combine="total")
    def run_rowcounts_batch(self, flags: tuple, leaves) -> torch.Tensor:
        """K whole-plane row-count items -> int32[K, R_pad]: per item,
        ``row_counts`` over the plane (ANDed with a filter when
        ``flags[k]``), reduced over the shard axis in int32 — exact while
        n_shards * 2^20 < 2^31; callers gate on that.  Leaves alternate
        plane[, filter] per item."""
        rows = []
        i = 0
        for has_filter in flags:
            plane = leaves[i]
            flt = leaves[i + 1] if has_filter else None
            i += 2 if has_filter else 1
            rows.append(kernels.row_counts(plane, flt)
                        .sum(0, dtype=torch.int32))
        return torch.stack(rows)

    @per_block(combine="total")
    def run_selected_counts(self, plane: torch.Tensor, slots: tuple,
                            delta=None) -> torch.Tensor:
        """N selected-row Counts over one plane -> int32[bucket]: the
        width pads to a pow2 bucket by repeating the LAST slot (a sorted
        slot list stays non-decreasing), the shard axis reduces in int32
        (callers gate on the int32-exact shard bound) and callers slice
        the pad off.  ``delta`` (an ``ingest.delta.DeltaOverlay``) merges
        the plane's pending write cells: base+delta."""
        bucket = pow2_bucket(len(slots))
        padded = tuple(slots) + (slots[-1],) * (bucket - len(slots))
        idx = torch.tensor(padded, dtype=torch.int32)  # host slot list
        if delta is not None:
            return adjusted_selected_counts(plane, idx, delta.rows,
                                            delta.words, delta.vals)
        return kernels.selected_row_counts(plane, idx).sum(
            0, dtype=torch.int32)

    @per_block(combine=lambda a: "total" if a["reduce"] else "gather")
    def run_rowcounts_delta(self, plane: torch.Tensor, delta,
                            filter_words: torch.Tensor | None = None,
                            reduce: bool = True) -> torch.Tensor:
        """Whole-plane per-row counts of base+delta: the clean
        ``row_counts`` scan of the unchanged base plus the overlay's
        per-cell adjustment -> int32[R_pad] (``reduce``; callers gate on
        the int32-exact shard bound) or int32[S, R_pad]."""
        return adjusted_row_counts(plane, delta.rows, delta.words,
                                   delta.vals, filter_words,
                                   reduce_shards=reduce)

    # -- whole trees -------------------------------------------------------

    @staticmethod
    def _tree_gather(plane: torch.Tensor, slots: tuple,
                     delta) -> torch.Tensor:
        """The window's ONE pass over the plane: gather the union of the
        items' row slots and write the overlay's cells over them
        (base+delta) -> int32[G, S, W] (a view; row g is
        ``out[g]``).  No pow2 padding: it only bounded the reference's
        compiled shapes, and here a pad lane would copy a whole row."""
        r_pad = plane.shape[1]
        idx = _host_index(slots or (0,), r_pad, plane.device)
        sel = plane.index_select(1, idx)             # [S, G, W]
        if delta is not None:
            overlay_gathered_rows(sel, idx, delta.rows, delta.words,
                                  delta.vals, r_pad)
        return sel.transpose(0, 1)

    @staticmethod
    def _tree_item(rows: torch.Tensor, extras: tuple, prog: tuple,
                   want: str) -> torch.Tensor:
        """One tree's postfix program over the window's gathered rows:
        "count" -> int32[1] (per-shard popcounts by the ``count`` kernel,
        the shard axis reduced in int32: callers gate on the int32-exact
        shard bound); "words" -> int32[S, W]."""
        words = kernels.tree_fold(
            rows, _skeleton(prog),
            [arg for op, arg in prog if op == kernels.TREE_PUSH],
            extras,
            [arg for op, arg in prog if op == kernels.TREE_PUSHX])
        if want == "words":
            return words
        return kernels.count(words).sum(dtype=torch.int32).reshape(1)

    @staticmethod
    def _tree_solo(plane: torch.Tensor, slots: tuple, prog: tuple,
                   extras: tuple, delta, want: str) -> torch.Tensor:
        """A SINGLE tree: each push reads its row straight off the plane
        (a strided [S, W] view, no gathered copy), with the overlay's
        cells of that row written over a copy of it."""
        r_pad = plane.shape[1]
        row_args = [slots[arg] for op, arg in prog
                    if op == kernels.TREE_PUSH]
        if row_args and (min(row_args) < 0 or max(row_args) >= r_pad):
            raise IndexError(f"tree slots outside [0, {r_pad})")
        skeleton = _skeleton(prog)
        zero = (torch.zeros_like(plane[:, 0, :])
                if any(op == kernels.TREE_ZERO for op, _ in prog) else None)
        words = kernels.tree_fold(
            lambda slot: _plane_row(plane, slot, delta), skeleton, row_args,
            extras, [arg for op, arg in prog if op == kernels.TREE_PUSHX],
            zero=zero)
        if want == "words":
            # a bare push is a strided view of the plane: the count and
            # row_counts kernels take contiguous operands
            return words.contiguous()
        return gathered(kernels.count(words)).sum(
            dtype=torch.int32).reshape(1)

    def _tree_program(self, plane, slots: tuple, progs: tuple,
                      extras: tuple, delta, want: str) -> torch.Tensor:
        """The programs per block, or, when one holds an op that reads
        other blocks' bits (:func:`kernels.crosses_blocks`), each folded
        solo over the blocked plane and operands, that op included, the
        outputs packed as the per-block path packs them."""
        if isinstance(plane, Blocked) and any(
                kernels.crosses_blocks(op, plane)
                for prog in progs for op, _ in prog):
            outs = tuple(self._tree_solo(plane, slots, prog, extras, delta,
                                         want) for prog in progs)
            return outs[0] if len(outs) == 1 else self.run_readback_pack(outs)
        return self._tree_blocks(plane, slots, progs, extras, delta, want)

    @per_block(combine=lambda a: "total" if a["want"] == "count"
               else "blocked")
    def _tree_blocks(self, plane, slots: tuple, progs: tuple,
                     extras: tuple, delta, want: str) -> torch.Tensor:
        """A single tree runs solo; a window of several gathers the slot
        union once and folds each item's program over the gathered rows,
        the item outputs packed into one tensor (one read).  ``progs``'
        PUSH args address ``slots`` and PUSHX args ``extras``
        (``exec.tree.assemble_items``)."""
        if len(progs) == 1:
            return self._tree_solo(plane, slots, progs[0], extras, delta,
                                   want)
        rows = self._tree_gather(plane, slots, delta)
        return self.run_readback_pack(tuple(
            self._tree_item(rows, extras, prog, want) for prog in progs))

    def run_tree_counts(self, plane: torch.Tensor, slots: tuple,
                        progs: tuple, extras: tuple = (),
                        delta=None) -> torch.Tensor:
        """K compound-tree Counts over ONE resident plane (base+delta
        when ``delta`` is set) -> device int32[K] totals, un-read."""
        return self._tree_program(plane, slots, progs, extras, delta,
                                  "count")

    def run_tree_words(self, plane: torch.Tensor, slots: tuple,
                       prog: tuple, extras: tuple = (),
                       delta=None) -> torch.Tensor:
        """One compound tree's bitmap int32[S, W] (bitmap-valued calls,
        TopN filters)."""
        return self._tree_program(plane, slots, (prog,), extras, delta,
                                  "words")

    @staticmethod
    @per_block
    def run_time_range(plane: torch.Tensor, start: int, length: int,
                       delta=None) -> torch.Tensor:
        """One time field's ``[t0, t1)`` bitmap int32[S, W] off its bucketed
        plane (:mod:`pilosa_tpu_torch.timeviews`): the OR of the
        CONTIGUOUS lanes ``[start, start + length)``, lane by lane into one
        accumulator (a view of each lane, never a gathered [S, L, W]
        copy), then the overlay's (row, bucket) cells over the columns
        they touch; per block under a placement, with the block's overlay
        part.  The reference gathers pow2-padded lanes for its compiled
        shapes and masks the pad after the overlay; with no pad lanes the
        answer is the same."""
        if start < 0 or start + length > plane.shape[1]:
            raise IndexError(f"time lanes [{start}, {start + length}) "
                             f"outside [0, {plane.shape[1]})")
        if length <= 0:
            return plane.new_zeros(plane.shape[0], plane.shape[2])
        acc = (plane[:, start].clone() if length == 1
               else torch.bitwise_or(plane[:, start], plane[:, start + 1]))
        for lane in range(start + 2, start + length):
            acc.bitwise_or_(plane[:, lane])
        if delta is not None:
            overlay_time_range(acc, plane, start, length, delta.rows,
                               delta.words, delta.vals)
        return acc

    # -- BSI plane batches ------------------------------------------------

    @staticmethod
    def _item_filters(flags: tuple, filters: tuple):
        """Each item's filter (None when its flag is False)."""
        it = iter(filters)
        return [next(it) if has else None for has in flags]

    @per_block(combine="gather", dim=1)
    def run_sum_plane_batch(self, plane: torch.Tensor, flags: tuple,
                            filters: tuple, delta=None) -> torch.Tensor:
        """K BSI Sum items over ONE plane -> int32[K, S, 2*depth+1]
        (per-bit non-negative and negative counts, non-null count; decode
        with ``bsi.decode_sum_packed``).  ``flags[k]``: item k has a
        filter, taken in order from ``filters``.  With ``delta`` the mini
        side's counts fold into shard 0's row (Sum is linear over
        columns), so the layout is the same: under a placement each
        block's first row takes its own overlay part."""
        rows = []
        for flt in self._item_filters(flags, filters):
            sides = bsi_sides(plane, flt, delta)
            pos, neg, cnt = bsik.bit_counts(*sides[0])
            row = torch.cat([pos, neg, cnt[:, None]], dim=-1)
            if len(sides) > 1:
                mp, mn, mc = bsik.bit_counts(*sides[1])
                adj = torch.cat([mp.sum(0, dtype=torch.int32),
                                 mn.sum(0, dtype=torch.int32),
                                 mc.sum(dtype=torch.int32)[None]])
                row = torch.cat([row[:1] + adj, row[1:]])
            rows.append(row)
        return torch.stack(rows)

    @per_block(combine="concat", dim=1, steps=True)
    def run_minmax_plane_batch(self, plane: torch.Tensor, flags: tuple,
                               filters: tuple, delta=None):
        """K BSI Min/Max items over ONE plane -> int32[K, S (+ K_pad),
        2*depth+4] (decode with ``bsi.decode_minmax_packed``): with
        ``delta`` the mini side's touched columns append as pseudo-shard
        rows; pad columns carry count 0 and drop in the host combine.
        Under a placement each block appends its own overlay columns; on a
        2-D one the base side's descent steps sum over a shard's word
        blocks and each block's rows carry its part of the counts."""
        rows = []
        for flt in self._item_filters(flags, filters):
            (base, base_f), *mini = bsi_sides(plane, flt, delta)
            mm = yield from bsik.min_max_steps(base, base_f)
            rows.append(torch.cat(
                [bsik.pack_min_max(mm)]
                + [bsik.pack_min_max(bsik.min_max_bits(pl, fw))
                   for pl, fw in mini]))
        return torch.stack(rows)

    @per_block(combine="total")
    def run_range_batch(self, plane: torch.Tensor, specs: tuple,
                        operands: tuple, delta=None) -> torch.Tensor:
        """K BSI range Counts over ONE plane -> int32[K] totals (the shard
        axis reduced in int32: callers gate on the int32-exact shard
        bound).  ``specs[k]`` is ``(op_keys, has_filter)``; ``operands``
        holds per item each op's (masks, negative) and then the filter
        when flagged.  A two-op item ANDs its comparisons (between)."""
        totals = []
        i = 0
        for op_keys, has_filter in specs:
            preds = []
            for okey in op_keys:
                preds.append((operands[i], operands[i + 1], okey))
                i += 2
            flt = operands[i] if has_filter else None
            i += 1 if has_filter else 0
            total = None
            for pl, fw in bsi_sides(plane, flt, delta):
                words = None
                for masks, neg, okey in preds:
                    cmp = bsik.range_cmp(pl, masks, neg, fw,
                                         keys=(okey,))[okey]
                    words = cmp if words is None else words & cmp
                side = kernels.count(words).sum(dtype=torch.int32)
                total = side if total is None else total + side
            totals.append(total)
        return torch.stack(totals)

    @staticmethod
    def run_percentile(plane: torch.Tensor, filter_words, nth: float):
        """Percentile: the non-null total (one read), then the search on
        the device with the exact host-computed integer rank (``ceil`` in
        float64 on the host).  Returns (device int32[2] (offset, count) |
        None, total)."""
        total = int(bsik.percentile_total(plane, filter_words))
        if total == 0:
            return None, 0
        target = min(total, max(1, math.ceil(nth / 100.0 * total)))
        return bsik.percentile_search(plane, filter_words, target), total

    @staticmethod
    def run_groupby_batch(planes: tuple, combo_idx, last_plane: torch.Tensor,
                          filter_words, agg_plane, agg: str | None,
                          delta=None) -> torch.Tensor:
        """One GroupBy combination block (:func:`exec.groupby.groupby_out`)
        flattened into one int32 tensor in ``block_part_names`` order, so
        the block joins a window's packed read; ``delta`` (the bit plane's
        ``BsiOverlay``) answers aggregates base+delta.  Unflatten with
        ``exec.groupby.unflatten_block``."""
        out = gb.groupby_out_any(planes, combo_idx, last_plane, filter_words,
                             agg_plane, agg,
                             agg_delta=delta if agg_plane is not None
                             else None)
        return torch.cat([out[name].reshape(-1)
                          for name in gb.block_part_names(agg)])

    @staticmethod
    def run_readback_pack(arrays: tuple) -> torch.Tensor:
        """The flattened int32 outputs of a window's families as ONE
        device tensor: the window then costs one device-to-host copy."""
        return torch.cat([a.reshape(-1) for a in arrays])


@per_block
def _plane_row(plane: torch.Tensor, slot: int, delta) -> torch.Tensor:
    """Row ``slot`` of ``plane`` int32[S, R, W] (a strided view), or a copy
    of it with the overlay's cells of that row written over it."""
    val = plane[:, slot, :]
    if delta is not None:
        val = overlay_row(val, slot, delta.rows, delta.words, delta.vals,
                          plane.shape[1])
    return val


def _shifts(node) -> bool:
    """Whether a planned tree holds a ``shift`` node."""
    kind = node[0]
    if kind == "shift":
        return True
    if kind in _BINARY:
        return any(_shifts(c) for c in node[1])
    return kind == "not" and _shifts(node[1])


def _skeleton(prog: tuple) -> tuple:
    """A postfix program's opcodes for ``kernels.tree_fold``: a static op
    keeps its argument as ``(opcode, arg)``."""
    return tuple((op, arg) if op in kernels.TREE_STATIC_OPS else op
                 for op, arg in prog)


def _host_index(values, bound: int, device) -> torch.Tensor:
    """int64 index tensor on ``device`` from host ints checked against
    ``[0, bound)`` on the host (an out-of-range index on the card is a
    device-side assert); reaches the card by an asynchronous copy from
    pinned memory."""
    values = tuple(int(v) for v in values)
    if values and (min(values) < 0 or max(values) >= bound):
        raise IndexError(f"slots [{min(values)}, {max(values)}] outside "
                         f"[0, {bound})")
    idx = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx
