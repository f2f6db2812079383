"""Whole-tree compilation of compound boolean calls, and the boolean-algebra
fold every planner shares (``pilosa_tpu.exec.tree``).

:func:`lower_count_tree` lowers a compound call to a canonical, hashable
:class:`TreeSpec`: every plain ``Row`` of the first (anchor) set field
becomes a row of ONE gather from that field's resident plane, rows of
other set fields and the existence row (``All``, ``Not``) enter as extra
operands, and the operators become a postfix program of
:mod:`pilosa_tpu_torch.engine.kernels` tree opcodes.  Duplicate leaves
collapse to one operand (CSE within a request); across concurrent
requests the batcher unions the gathered slots (:func:`assemble_items`),
so N windowed trees over one plane cost one gather.

Lowered here: ``Row`` on set and time fields, ``All``, ``Intersect`` /
``Union`` / ``Difference`` / ``Xor`` / ``Not``, ``UnionRows`` (its rows
pushed and ORed: the row set comes from data, so the spec is volatile),
and these extra operands: BSI conditions in ``Row`` / ``Range`` (each
comparison ``("bsi", field, op_key, offset)``, a between two of them
ANDed, a predicate past the bit depth ``("bsi-exists", field)`` or an
empty push), time-range rows ``("trange", field, row, from, to)`` (one OR
over the field's time plane, or the union of its cover views) and
``ConstRow`` ``("constrow", columns)``.  ``Shift`` and ``Limit`` are static
unary ops whose arguments are program structure.
:class:`~pilosa_tpu_torch.exec.fused.Unfusable` (the caller takes the
generic planned path, with the same answers) for a tree with no plain row
to anchor the gather, deeper than ``TREE_STACK_DEPTH`` or longer than
``TREE_MAX_PROG``.
"""

from __future__ import annotations

from dataclasses import dataclass

from pilosa_tpu_torch.engine.kernels import (TREE_AND, TREE_LIMIT,
                                             TREE_PUSH, TREE_PUSHX,
                                             TREE_SHIFT, TREE_STACK_DEPTH,
                                             TREE_STATIC_OPS, TREE_ZERO)
from pilosa_tpu_torch.exec.fused import Unfusable
from pilosa_tpu_torch.pql.ast import BOOL_CALLS, Call
from pilosa_tpu_torch.store.view import VIEW_STANDARD

# the compound-call names the tree compiler owns (a bare Row/All Count
# keeps the selected / whole-plane serving paths)
TREE_CALLS = (frozenset(BOOL_CALLS)
              | {"Not", "UnionRows", "Shift", "Limit", "ConstRow"})

# program-length cap: past it the tree takes the generic path
TREE_MAX_PROG = 96

# op token -> tree opcode (pql.ast.BOOL_CALLS names the tokens)
_OP_CODE = {"and": TREE_AND, "or": TREE_AND + 1,
            "andnot": TREE_AND + 2, "xor": TREE_AND + 3}

_NOT_BOOL = object()


def fold_bool_call(call: Call, recurse, zeros, exists, combine,
                   complement):
    """- ``Union()`` with no children is the empty bitmap (``zeros()``);
    - every other operator requires >= 1 child, and with exactly one
      child IS that child;
    - ``Not`` is unary and evaluates as ``andnot(exists, x)``;
      ``complement(exists_thunk, child_thunk)`` controls evaluation order
      (the postfix lowering pushes ``exists`` first);
    - n-ary operators call ``combine(op, child_thunks)`` once with every
      child as a thunk.

    Returns the folded value, or :data:`_NOT_BOOL` when ``call`` is not a
    boolean-algebra operator (test with :func:`is_not_bool`)."""
    from pilosa_tpu_torch.exec.executor import ExecutionError
    name = call.name
    if name == "Not":
        if len(call.children) != 1:
            raise ExecutionError("Not: exactly one child required")
        return complement(exists, lambda: recurse(call.children[0]))
    op = BOOL_CALLS.get(name)
    if op is None:
        return _NOT_BOOL
    kids = call.children
    if not kids:
        if name == "Union":
            return zeros()
        raise ExecutionError(f"{name}: at least one child required")
    return combine(op, tuple((lambda k=kid: recurse(k))
                             for kid in kids))


def is_not_bool(value) -> bool:
    return value is _NOT_BOOL


@dataclass(frozen=True)
class TreeSpec:
    """One compound tree as a canonical, hashable spec (the plan-cache
    unit for tree shapes).  Nothing here is a tensor: ``rows`` re-resolve
    to plane slots and ``extras`` re-materialize through the plane cache
    on every use."""

    field: str        # anchor set field whose plane rows are gathered
    rows: tuple       # gathered row ids (first-use order, CSE-deduped)
    extras: tuple     # ("exists",) | ("row", field, view, row_id) |
    #                   ("bsi", field, op_key, offset) | ("bsi-exists", field)
    #                   | ("trange", field, row_id, from, to) |
    #                   ("constrow", columns)
    prog: tuple       # ((opcode, arg), ...) postfix; PUSH args index
    #                   rows, PUSHX args index extras, static ops carry
    #                   their shift distance or (offset, limit)
    depth: int        # operator nesting depth
    cse_hits: int     # duplicate leaves collapsed inside this request
    bsi_fields: tuple = ()  # BSI fields whose predicates were resolved
    #                         against their depth and base
    volatile: bool = False  # the row set depends on data (UnionRows)
    keyed: tuple = ()       # keyed fields whose row keys were resolved


class _Lower:
    """One lowering pass: call tree -> postfix program + operand pools.
    A tree past ``TREE_STACK_DEPTH`` live values or ``TREE_MAX_PROG``
    steps raises :class:`Unfusable`."""

    def __init__(self, ex, ctx):
        self.ex = ex
        self.ctx = ctx
        self.field = None                       # anchor Field
        self.rows: dict[int, int] = {}          # row id -> arg pos
        self.extras: dict[tuple, int] = {}      # extra spec -> pos
        self.prog: list = []
        self.sp = 0
        self.max_sp = 0
        self.depth = 0
        self.cse_hits = 0
        self.bsi_fields: dict[str, None] = {}
        self.volatile = False
        self.keyed: dict[str, None] = {}

    def _emit(self, op: int, arg=0) -> None:
        if op not in TREE_STATIC_OPS:  # a static op pops one, pushes one
            self.sp += -1 if op >= TREE_AND else 1
        self.max_sp = max(self.max_sp, self.sp)
        if self.max_sp > TREE_STACK_DEPTH:
            raise Unfusable("tree deeper than the fused operand stack")
        if len(self.prog) >= TREE_MAX_PROG:
            raise Unfusable("tree program longer than TREE_MAX_PROG")
        self.prog.append((op, arg))

    def _extra(self, spec: tuple):
        pos = self.extras.get(spec)
        if pos is None:
            pos = self.extras[spec] = len(self.extras)
        else:
            self.cse_hits += 1
        return ("e", pos)

    def _push_exists(self) -> None:
        self.ex._existence_field(self.ctx)  # raises without one
        self._emit(TREE_PUSH, self._extra(("exists",)))

    def _push_field_row(self, field, row_id: int) -> None:
        if self.field is None:
            self.field = field
        if field.name == self.field.name:
            pos = self.rows.get(row_id)
            if pos is None:
                pos = self.rows[row_id] = len(self.rows)
            else:
                self.cse_hits += 1
            self._emit(TREE_PUSH, ("r", pos))
            return
        # rows of OTHER set fields enter as extra operands
        self._emit(TREE_PUSH, self._extra(
            ("row", field.name, VIEW_STANDARD, row_id)))

    def _bsi(self, field, cond) -> None:
        """A BSI condition: each comparison an extra operand (a between's
        two ANDed), a predicate past the depth the exists row or empty."""
        from pilosa_tpu_torch.exec.executor import bsi_cmp_pairs, bsi_offset
        self.bsi_fields[field.name] = None
        pairs = bsi_cmp_pairs(cond)
        for op_key, value in pairs:
            offset, all_hit = bsi_offset(field, op_key, value)
            if all_hit is None:
                self._emit(TREE_PUSH, self._extra(
                    ("bsi", field.name, op_key, offset)))
            elif all_hit:
                self._emit(TREE_PUSH, self._extra(
                    ("bsi-exists", field.name)))
            else:
                self._emit(TREE_ZERO)
        if len(pairs) == 2:
            self._emit(_OP_CODE["and"])

    def lower(self, call: Call, depth: int) -> None:
        name = call.name
        if name in ("Row", "Range"):
            self._leaf(call)
            return
        if name == "All":
            self._push_exists()
            return
        self.depth = max(self.depth, depth)
        if name == "UnionRows":
            self._union_rows(call)
            return
        if name == "Shift":
            from pilosa_tpu_torch.exec.executor import ExecutionError
            if len(call.children) != 1:
                raise ExecutionError("Shift: exactly one child required")
            n = self.ex._shift_n(call)  # the eager path's checks and texts
            self.lower(call.children[0], depth + 1)
            self._emit(TREE_SHIFT, n)
            return
        if name == "Limit":
            offset, limit = self.ex._limit_args(call)
            self.lower(call.children[0], depth + 1)
            self._emit(TREE_LIMIT, (offset, -1 if limit is None else limit))
            return
        if name == "ConstRow":
            self._emit(TREE_PUSH, self._extra(
                ("constrow", tuple(self.ex._const_row_arg(call)))))
            return

        def emit_fold(op, kids):
            kids[0]()
            for child in kids[1:]:
                child()
                self._emit(_OP_CODE[op])

        out = fold_bool_call(
            call,
            recurse=lambda c: self.lower(c, depth + 1),
            zeros=lambda: self._emit(TREE_ZERO),
            exists=self._push_exists,
            combine=emit_fold,
            complement=lambda exists, child: (exists(), child(),
                                              self._emit(
                                                  _OP_CODE["andnot"])))
        if is_not_bool(out):
            raise Unfusable(f"{name} is not tree-compiled by this port")

    def _leaf(self, call: Call) -> None:
        bsi = self.ex._bsi_leaf(self.ctx, call)
        if bsi is not None:
            self._bsi(*bsi)
            return
        field, row_id = self.ex._row_leaf(self.ctx, call)
        if field.options.keys:
            self.keyed[field.name] = None
        if row_id is None:  # an unknown key: an empty row
            self._emit(TREE_ZERO)
            return
        rng = self.ex._time_args(field, call)
        if rng is not None:
            # one extra operand: the OR over the field's time plane (or the
            # union of its cover views); the row resolves first, as in the
            # eager path
            self._emit(TREE_PUSH, self._extra(("trange", field.name,
                                               row_id) + rng))
            return
        self._push_field_row(field, row_id)

    def _union_rows(self, call: Call) -> None:
        """``UnionRows(Rows(f), ...)``: every selected row pushed and ORed.
        The row set comes from data, not from the query text, so the spec
        is volatile: a plan of it must not outlive a write."""
        self.volatile = True
        n = 0
        for field, rows in self.ex._union_rows_sel(self.ctx, call):
            for r in rows:
                self._push_field_row(field, int(r))
                n += 1
                if n > 1:
                    self._emit(_OP_CODE["or"])
        if n == 0:
            self._emit(TREE_ZERO)


def lower_count_tree(ex, ctx, call: Call) -> TreeSpec:
    """Lower one compound bitmap call (a ``Count`` child, or a bitmap
    call) to a canonical :class:`TreeSpec`.  Raises :class:`Unfusable`
    for shapes the tree path does not cover and ``ExecutionError`` for
    query errors, with the eager planner's texts."""
    low = _Lower(ex, ctx)
    low.lower(call, 1)
    if low.field is None:
        raise Unfusable("no plain-row leaf to anchor the plane gather")
    # rows stay TREE_PUSH (arg = row position), extras become TREE_PUSHX
    # (arg = extra position)
    prog = tuple(
        ((TREE_PUSH, arg[1]) if arg[0] == "r" else (TREE_PUSHX, arg[1]))
        if (op == TREE_PUSH and isinstance(arg, tuple)) else (op, arg)
        for op, arg in low.prog)
    return TreeSpec(field=low.field.name, rows=tuple(low.rows),
                    extras=tuple(low.extras), prog=prog,
                    depth=low.depth, cse_hits=low.cse_hits,
                    bsi_fields=tuple(low.bsi_fields),
                    volatile=low.volatile, keyed=tuple(low.keyed))


def assemble_items(items) -> tuple:
    """Union the items' gathered plane slots and extra tensors and remap
    every postfix program into the shared operand space: N windowed trees
    over overlapping rows of one plane pay ONE gather of the slot union,
    and the same extra tensor (same exists row, same other-field row)
    enters once.

    ``items``: ``(slots, prog, extras)`` per tree, PUSH args addressing
    that item's ``slots`` and PUSHX args its ``extras``.  Returns
    ``(slot_union, progs, extra_list)`` in the operand order of
    :meth:`FusedCache.run_tree_counts`."""
    slot_pos: dict[int, int] = {}
    extra_pos: dict[int, int] = {}
    extra_arrays: list = []
    for slots, _prog, extras in items:
        for s in slots:
            if s not in slot_pos:
                slot_pos[s] = len(slot_pos)
        for a in extras:
            if id(a) not in extra_pos:
                extra_pos[id(a)] = len(extra_arrays)
                extra_arrays.append(a)
    progs = []
    for slots, prog, extras in items:
        out = []
        for op, arg in prog:
            if op == TREE_PUSH:
                arg = slot_pos[slots[arg]]
            elif op == TREE_PUSHX:
                arg = extra_pos[id(extras[arg])]
            out.append((op, arg))
        progs.append(tuple(out))
    return tuple(slot_pos), tuple(progs), tuple(extra_arrays)
