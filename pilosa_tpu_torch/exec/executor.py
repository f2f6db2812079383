"""Executor: PQL AST -> hand-written kernels over resident planes.

The counterpart of ``pilosa_tpu.exec.executor.Executor`` in its
``count_batch_window="off", tree_fusion=False, plane_paging=False``
configuration: every resident shard is one slice of a batched device
tensor, a run of consecutive Counts executes as one batch with one host
read, and cross-shard totals are a dense sum.  Writes since a plane was
built ride a device delta overlay (``delta_cells``, folded in the
background past ``delta_compact_fraction``): whole-plane Counts and TopN
answer base+delta over the unchanged resident plane.

Served calls: ``Count``, ``Row`` (set fields, integer rows),
``Intersect``, ``Union``, ``Difference``, ``Xor``, ``Not``, ``All``,
``TopN(field[, filter], n=)`` on the dense plane, ``Set`` and ``Clear``.
Anything else raises :class:`ExecutionError`.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.engine import kernels, resolve_device
from pilosa_tpu_torch.engine.words import (SHARD_WIDTH, WORDS_PER_SHARD,
                                           unpack_columns)
from pilosa_tpu_torch.exec.fused import FusedCache, shift_leaves
from pilosa_tpu_torch.exec.planes import DEFAULT_BUDGET, PlaneCache
from pilosa_tpu_torch.exec.result import Pair, PairsResult, RowResult
from pilosa_tpu_torch.exec.tree import fold_bool_call, is_not_bool
from pilosa_tpu_torch.pql import parse_cached
from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.store.field import TYPE_SET, Field
from pilosa_tpu_torch.store.holder import Holder
from pilosa_tpu_torch.store.index import Index
from pilosa_tpu_torch.store.view import VIEW_STANDARD

# option keys that are never field names in call args (reservation is per
# call: a field named "n" still works in Set(5, n=777))
RESERVED_KEYS = frozenset({
    "from", "to", "limit", "offset", "n", "field", "ids", "filter", "column",
    "like", "previous", "aggregate", "sort", "shards", "index",
    "attrName", "attrValue", "columnAttrs", "excludeColumns", "tanimoto",
    "excludeRowAttrs",
})

_CALL_RESERVED = {
    "Row": frozenset({"from", "to", "excludeRowAttrs"}),
    "Set": frozenset(),
    "Clear": frozenset(),
}

_BITMAP_CALLS = frozenset({"Row", "Intersect", "Union", "Difference",
                           "Xor", "Not", "All"})


class ExecutionError(Exception):
    pass


def _field_arg(call: Call):
    try:
        return call.field_arg(_CALL_RESERVED.get(call.name, RESERVED_KEYS))
    except ValueError as e:
        raise ExecutionError(str(e))


class _Ctx:
    def __init__(self, index: Index, shards: tuple[int, ...]):
        self.index = index
        self.shards = shards


class Executor:
    # cross-shard sums stay int32 on the device while
    # n_shards * 2^20 < 2^31
    _REDUCE_SHARD_MAX = (1 << 31) // SHARD_WIDTH - 1
    # selected-row gather when the request touches at most 1/4 of the
    # (padded) row axis; whole-plane row_counts otherwise
    _SELECTED_ROWS_FRACTION = 4

    def __init__(self, holder: Holder, device=None,
                 plane_budget: int = DEFAULT_BUDGET,
                 delta_cells: int = 65536,
                 delta_compact_fraction: float = 0.5):
        self.holder = holder
        self.device = resolve_device(device)
        self.planes = PlaneCache(
            self.device, budget_bytes=plane_budget, delta_cells=delta_cells,
            delta_compact_fraction=delta_compact_fraction)
        self.fused = FusedCache()

    # ------------------------------------------------------------------ api

    def execute(self, index_name: str, query: str | Query,
                shards: list[int] | None = None) -> list:
        """Run every top-level call; returns one result per call."""
        index = self.holder.index(index_name)
        if index is None:
            raise ExecutionError(f"index {index_name!r} not found")
        if isinstance(query, str):
            query = parse_cached(query)
        results = []
        calls = query.calls
        i = 0
        while i < len(calls):
            # runs of consecutive Counts execute as ONE batch with one
            # host read (consecutive only: a write between counts must
            # stay ordered)
            run_end = i
            while (run_end < len(calls) and calls[run_end].name == "Count"
                   and len(calls[run_end].children) == 1):
                run_end += 1
            ctx = _Ctx(index, self._shards_for(index, shards))
            if run_end - i > 1:
                results.extend(self._count_batch(ctx, calls[i:run_end]))
                i = run_end
                continue
            results.append(self._call(ctx, calls[i]))
            i += 1
        return results

    # ------------------------------------------------------- Count batches

    def _count_batch(self, ctx: _Ctx, calls: list[Call]) -> list[int]:
        fast = self._count_batch_plane(ctx, calls)
        if fast is not None:
            return fast
        nodes, all_leaves = [], []
        for call in calls:
            leaves: list = []
            node = self._plan(ctx, call.children[0], leaves)
            nodes.append(shift_leaves(node, len(all_leaves)))
            all_leaves.extend(leaves)
        per_shard = self.fused.run_count_batch(tuple(nodes),
                                               tuple(all_leaves))
        host = per_shard.cpu().numpy().astype(np.int64)  # one read
        return [int(row.sum()) for row in host]

    def _count_batch_plane(self, ctx: _Ctx, calls: list[Call]) \
            -> list[int] | None:
        """Same-field plain-row Count batches run over the resident
        whole-field plane.  None when the batch doesn't match, or when a
        plane that is not resident yet is over budget or would be scanned
        for a small slice of its rows.  A resident plane behind the
        fragments absorbs the write gap into its overlay."""
        hit = self._plain_row_parse(ctx, calls)
        if hit is None:
            return None
        field, values = hit
        if not self.planes.has_plane(ctx.index.name, field, VIEW_STANDARD,
                                     ctx.shards):
            est = self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
            if est > self.planes.budget:
                return None
            r_est = max(1, est // (len(ctx.shards) * WORDS_PER_SHARD * 4))
            if len(calls) * 4 < r_est:
                return None
        row_ids = [self._row_id(field, v) for v in values]
        ps = self.planes.field_plane_delta(ctx.index.name, field,
                                           VIEW_STANDARD, ctx.shards)
        return self._plane_count_rows(ps, row_ids)

    def _plain_row_parse(self, ctx: _Ctx, calls: list[Call]):
        """``(field, values)`` when every call is ``Count(Row(f=v))`` over
        ONE set field with plain scalar rows; None otherwise."""
        fname = None
        values = []
        for call in calls:
            child = call.children[0]
            if child.name != "Row" or child.children:
                return None
            hit = _field_arg(child)
            if hit is None:
                return None
            f, v = hit
            if isinstance(v, (Condition, Call)):
                return None
            if ("from" in child.args or "to" in child.args
                    or "_timestamp" in child.args):
                return None
            if fname is None:
                fname = f
            elif f != fname:
                return None
            values.append(v)
        if fname is None:
            return None
        field = self._field(ctx, fname)
        if field.options.type != TYPE_SET or not ctx.shards:
            return None
        return field, values

    def _plane_count_rows(self, ps, row_ids) -> list[int]:
        """Per-call totals for ``row_ids`` over a resident plane: the
        selected-row gather when the request touches a small fraction of
        the rows, the whole-plane row counts otherwise; base+delta when
        the plane carries an overlay."""
        slots = [ps.slot_of.get(int(r)) for r in row_ids]
        live = list(dict.fromkeys(s for s in slots if s is not None))
        r_pad = ps.plane.shape[-2]
        if (live and len(ps.shards) <= self._REDUCE_SHARD_MAX
                and len(live) * self._SELECTED_ROWS_FRACTION <= r_pad):
            vals = self.fused.run_selected_counts(ps.plane, tuple(live),
                                                  ps.delta)
            vals = vals.cpu().numpy().astype(np.int64)[:len(live)]
            by_slot = dict(zip(live, vals.tolist()))
            return [int(by_slot[s]) if s is not None else 0 for s in slots]
        totals = self._plane_totals(ps)
        return [int(totals[s]) if s is not None else 0 for s in slots]

    def _plane_totals(self, ps) -> np.ndarray:
        """Whole-plane per-row totals int64[R_pad]: reduced over shards
        on the device while int32 stays exact, else per shard and
        finished in int64 on the host."""
        small = len(ps.shards) <= self._REDUCE_SHARD_MAX
        if ps.delta is not None:
            out = self.fused.run_rowcounts_delta(ps.plane, ps.delta,
                                                 reduce=small)
            if small:
                return out.cpu().numpy().astype(np.int64)
            return kernels.shard_totals(out)
        if small:
            out = self.fused.run_rowcounts_batch((False,), (ps.plane,))[0]
            return out.cpu().numpy().astype(np.int64)
        return kernels.shard_totals(kernels.row_counts(ps.plane))

    def _shards_for(self, index: Index, shards) -> tuple[int, ...]:
        if shards is not None:
            return tuple(shards)
        avail = index.available_shards()
        return tuple(avail) if avail else (0,)

    # ------------------------------------------------------------- dispatch

    def _call(self, ctx: _Ctx, call: Call):
        if call.name in _BITMAP_CALLS:
            return self._to_row_result(ctx, self._fused_bitmap(ctx, call))
        handler = {"Count": self._execute_count, "TopN": self._execute_topn,
                   "Set": self._execute_set,
                   "Clear": self._execute_clear}.get(call.name)
        if handler is None:
            raise ExecutionError(
                f"call {call.name!r} is not supported by this port")
        return handler(ctx, call)

    def _fused_bitmap(self, ctx: _Ctx, call: Call, want: str = "words"):
        leaves: list = []
        node = self._plan(ctx, call, leaves)
        return self.fused.run(node, tuple(leaves), want)

    def _plan(self, ctx: _Ctx, call: Call, leaves: list):
        """Collect leaf tensors and return the hashable node tree."""

        def leaf(arr) -> tuple:
            leaves.append(arr)
            return ("leaf", len(leaves) - 1)

        if call.name == "Row":
            return leaf(self._row_words(ctx, call))
        if call.name == "All":
            return leaf(self._exists(ctx))

        def exists_leaf() -> int:
            leaves.append(self._exists(ctx))
            return len(leaves) - 1

        out = fold_bool_call(
            call,
            recurse=lambda c: self._plan(ctx, c, leaves),
            zeros=lambda: leaf(self._zeros(ctx)),
            exists=exists_leaf,
            combine=lambda op, kids: (op, tuple(k() for k in kids)),
            complement=lambda exists, child:
                (lambda ch: ("not", ch, exists()))(child()))
        if is_not_bool(out):
            raise ExecutionError(
                f"bitmap call {call.name!r} is not supported by this port")
        return out

    def _row_words(self, ctx: _Ctx, call: Call) -> torch.Tensor:
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError(f"{call.name}: missing field argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if isinstance(value, Condition) or field.options.type != TYPE_SET:
            raise ExecutionError(
                f"Row on {field.options.type!r} field {fname!r} is not "
                "supported by this port")
        if ("from" in call.args or "to" in call.args
                or "_timestamp" in call.args):
            raise ExecutionError("time-range rows are not supported by "
                                 "this port")
        return self.planes.row_words(ctx.index.name, field, VIEW_STANDARD,
                                     self._row_id(field, value), ctx.shards)

    # -- helpers ------------------------------------------------------------

    def _field(self, ctx: _Ctx, name: str) -> Field:
        field = ctx.index.field(name)
        if field is None:
            raise ExecutionError(
                f"field {name!r} not found in index {ctx.index.name!r}")
        return field

    def _row_id(self, field: Field, value) -> int:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, str) or field.options.keys:
            raise ExecutionError(f"field {field.name!r}: keyed rows are "
                                 "not supported by this port")
        return int(value)

    def _col_id(self, ctx: _Ctx, value) -> int:
        if isinstance(value, str) or ctx.index.keys:
            raise ExecutionError(f"index {ctx.index.name!r}: keyed columns "
                                 "are not supported by this port")
        return int(value)

    def _exists(self, ctx: _Ctx) -> torch.Tensor:
        ef = ctx.index.existence_field
        if ef is None:
            raise ExecutionError(
                f"index {ctx.index.name!r} does not track existence "
                "(required for Not/All)")
        return self.planes.row_words(ctx.index.name, ef, VIEW_STANDARD, 0,
                                     ctx.shards)

    def _zeros(self, ctx: _Ctx) -> torch.Tensor:
        return self.planes.zeros(len(ctx.shards))

    def _to_row_result(self, ctx: _Ctx, words: torch.Tensor) -> RowResult:
        host = words.cpu().numpy().view(np.uint32)
        parts = []
        for si, s in enumerate(ctx.shards):
            offs = unpack_columns(host[si])
            if len(offs):
                parts.append(offs + np.uint64(s * SHARD_WIDTH))
        return RowResult(np.concatenate(parts) if parts
                         else np.empty(0, np.uint64))

    def _filter_words(self, ctx: _Ctx, call: Call) -> torch.Tensor | None:
        """Optional bitmap-call filter child (TopN)."""
        flt = call.args.get("filter")
        if flt is None and call.children:
            flt = call.children[0]
        if flt is None:
            return None
        if not isinstance(flt, Call):
            raise ExecutionError("filter must be a bitmap call")
        return self._fused_bitmap(ctx, flt)

    # -- calls --------------------------------------------------------------

    def _execute_count(self, ctx: _Ctx, call: Call) -> int:
        if len(call.children) != 1:
            raise ExecutionError("Count: exactly one child required")
        per_shard = self._fused_bitmap(ctx, call.children[0], want="count")
        return int(kernels.shard_totals(per_shard))

    def _execute_topn(self, ctx: _Ctx, call: Call) -> PairsResult:
        fname = call.args.get("_field") or call.args.get("field")
        if fname is None:
            raise ExecutionError("TopN: missing field argument")
        field = self._field(ctx, str(fname))
        for opt in ("tanimoto", "attrName", "_rowCounts"):
            if call.args.get(opt) is not None:
                raise ExecutionError(f"TopN: {opt}= is not supported by "
                                     "this port")
        n = call.args.get("n")
        filter_words = self._filter_words(ctx, call)
        if (not self.planes.has_entry(ctx.index.name, field, VIEW_STANDARD,
                                      ctx.shards)
                and self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
                > self.planes.budget):
            raise ExecutionError(
                f"TopN: field {field.name!r} exceeds the plane budget "
                f"({self.planes.budget} bytes); streaming TopN is not "
                "supported by this port")
        ps = self.planes.field_plane_delta(ctx.index.name, field,
                                           VIEW_STANDARD, ctx.shards)
        if ps.n_rows == 0:
            return PairsResult([])
        if ps.delta is not None:
            # per-shard base+delta counts, finished on the host
            totals = kernels.shard_totals(self.fused.run_rowcounts_delta(
                ps.plane, ps.delta, filter_words, reduce=False))[:ps.n_rows]
        elif len(ctx.shards) <= self._REDUCE_SHARD_MAX:
            # shard axis reduced on the device, one int32[R_pad] read
            flags = (filter_words is not None,)
            leaves = (ps.plane,) + ((filter_words,) if flags[0] else ())
            totals = self.fused.run_rowcounts_batch(flags, leaves)[0]
            totals = totals.cpu().numpy().astype(np.int64)[:ps.n_rows]
        else:
            totals = kernels.shard_totals(
                kernels.row_counts(ps.plane, filter_words))[:ps.n_rows]
        all_rows = ps.row_ids
        ids_arg = call.args.get("ids")
        if ids_arg is not None:
            wanted = {int(r) for r in ids_arg}
            keep = np.array([int(r) in wanted for r in all_rows])
            totals = np.where(keep, totals, 0)
        # host ordering: count descending, ties in row-id order
        k = len(all_rows) if n is None else min(int(n), len(all_rows))
        slots = np.argsort(-totals, kind="stable")[:k]
        vals = totals[slots]
        live = vals > 0
        return PairsResult([Pair(id=int(r), count=int(c))
                            for r, c in zip(all_rows[slots[live]],
                                            vals[live])])

    def _execute_set(self, ctx: _Ctx, call: Call) -> bool:
        col = call.args.get("_col")
        if col is None:
            raise ExecutionError("Set: missing column argument")
        col_id = self._col_id(ctx, col)
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("Set: missing field=value argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if field.options.type != TYPE_SET or "_timestamp" in call.args:
            raise ExecutionError(f"Set on {field.options.type!r} field "
                                 f"{fname!r} is not supported by this port")
        changed = field.set_bit(self._row_id(field, value), col_id)
        ctx.index.note_columns(np.array([col_id], np.uint64))
        return changed

    def _execute_clear(self, ctx: _Ctx, call: Call) -> bool:
        col = call.args.get("_col")
        if col is None:
            raise ExecutionError("Clear: missing column argument")
        col_id = self._col_id(ctx, col)
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("Clear: missing field argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if field.options.type != TYPE_SET:
            raise ExecutionError(f"Clear on {field.options.type!r} field "
                                 f"{fname!r} is not supported by this port")
        return field.clear_bit(self._row_id(field, value), col_id)
