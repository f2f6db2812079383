"""PQL AST node types.

Reference: ``pql/ast.go`` — ``pql.Query`` (list of calls), ``pql.Call``
(name, Args map, Children), ``pql.Condition`` (Op + Value) (SURVEY.md
§3.2).  Conventions kept from upstream:

- positional scalar args are stored under reserved keys the way the
  upstream grammar rewrites them (``Set(10, f=1)`` → ``_col=10``,
  trailing timestamp → ``_timestamp``, ``TopN(f, n=5)`` → ``_field=f``),
  so the executor sees one uniform Args map;
- a BSI condition arg (``Row(amount > 5)``) is stored as
  ``args[field] = Condition(op, value)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

# Condition ops.  Six scalar comparisons plus the four "between" variants
# the upstream grammar distinguishes (BETWEEN_LT_LT etc. in pql/token.go):
# the op string spells the two bounds' strictness, value is [lo, hi].
SCALAR_OPS = ("==", "!=", "<", "<=", ">", ">=")
BETWEEN_OPS = ("<><", "<=><", "<><=", "<=><=")  # lo(op)x(op)hi: <>< means lo<x<hi


# scalar condition op -> comparison key of ``engine.bsi.range_cmp``
SCALAR_CMP_KEYS = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge",
                   "==": "eq", "!=": "ne"}


def between_cmp_ops(op: str) -> tuple[str, str]:
    """One between op's (lo, hi) comparison keys against the stored
    values: ``<><`` is (gt, lt), ``<=><=`` is (ge, le).  Every executor
    lowering of a between condition maps through here."""
    return ("gt" if op.startswith("<>") else "ge",
            "lt" if op.endswith("><") else "le")

# the n-ary boolean-algebra calls and their canonical word-wise op
# tokens (reference: executeIntersect/executeUnion/... dispatch in
# executor.go).  This mapping is THE source of truth for operator
# semantics: the executor's eager path, both fused planners and the
# whole-tree compiler (exec/tree.py) all fold through it — `Not` is
# not listed because it is unary and lowers to `andnot(exists, x)`.
BOOL_CALLS = {"Union": "or", "Intersect": "and",
              "Difference": "andnot", "Xor": "xor"}


@dataclass(frozen=True)
class Condition:
    """A comparison against a BSI field: op + predicate value(s)."""

    op: str
    value: Any  # int | float | [lo, hi] for between ops

    def __post_init__(self):
        if self.op not in SCALAR_OPS + BETWEEN_OPS:
            raise ValueError(f"unknown condition op {self.op!r}")

    def __str__(self) -> str:
        if self.op in BETWEEN_OPS:
            lo_op = "<" if self.op.startswith("<>") else "<="
            hi_op = "<" if self.op.endswith("><") else "<="
            return f"{self.value[0]} {lo_op} x {hi_op} {self.value[1]}"
        return f"x {self.op} {self.value}"

    def matches(self, val) -> bool:
        """Host-side scalar evaluation (GroupBy ``having=`` filtering)."""
        return bool(self.matches_array(val))

    def matches_array(self, vals):
        """:meth:`matches` over a numpy array -> bool mask (the GroupBy
        having filter runs once per result block, not once per group)."""
        import numpy as np
        v = np.asarray(vals)
        if self.op in BETWEEN_OPS:
            lo, hi = self.value
            lo_ok = v > lo if self.op.startswith("<>") else v >= lo
            hi_ok = v < hi if self.op.endswith("><") else v <= hi
            return lo_ok & hi_ok
        c = self.value
        return {"==": v == c, "!=": v != c, "<": v < c,
                "<=": v <= c, ">": v > c, ">=": v >= c}[self.op]


@dataclass
class Call:
    """One PQL call: ``Name(child, ..., key=value, ...)``."""

    name: str
    args: dict[str, Any] = dc_field(default_factory=dict)
    children: list["Call"] = dc_field(default_factory=list)

    def field_arg(self, reserved: frozenset[str]) -> tuple[str, Any] | None:
        """The single (field, value) arg that is not a reserved option key —
        upstream resolves ``Row(f=1)``'s field name the same way at
        execution time, not parse time."""
        hits = [(k, v) for k, v in self.args.items()
                if k not in reserved and not k.startswith("_")]
        if not hits:
            return None
        if len(hits) > 1:
            raise ValueError(
                f"{self.name}: ambiguous field args {[k for k, _ in hits]}")
        return hits[0]

    def __str__(self) -> str:
        """Valid, re-parseable PQL (used to ship sub-queries to peer
        nodes — reference: ``InternalClient.QueryNode`` carrying the
        sub-AST, SURVEY.md §4.2).  ``parse(str(call))`` must equal
        ``call``."""
        parts: list[str] = []
        if "_field" in self.args:
            parts.append(str(self.args["_field"]))  # bareword field
        for slot in ("_col", "_row"):
            if slot in self.args:
                parts.append(_literal(self.args[slot]))
        parts += [str(c) for c in self.children]
        for k, v in self.args.items():
            if k in ("_field", "_col", "_row", "_timestamp", "_timestamp2"):
                continue
            if isinstance(v, Condition):
                parts.append(_condition_pql(k, v))
            else:
                parts.append(f"{k}={_literal(v)}")
        if "_timestamp" in self.args:
            parts.append(str(self.args["_timestamp"]))  # bare timestamp
        if "_timestamp2" in self.args:
            parts.append(str(self.args["_timestamp2"]))
        return f"{self.name}({', '.join(parts)})"


def _literal(v) -> str:
    """One PQL literal, re-parseable."""
    if isinstance(v, Call):
        return str(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, list):
        return "[" + ", ".join(_literal(x) for x in v) + "]"
    return str(v)


def _condition_pql(field: str, c: Condition) -> str:
    if c.op in BETWEEN_OPS:
        lo_op = "<" if c.op.startswith("<>") else "<="
        hi_op = "<" if c.op.endswith("><") else "<="
        return (f"{_literal(c.value[0])} {lo_op} {field} "
                f"{hi_op} {_literal(c.value[1])}")
    return f"{field} {c.op} {_literal(c.value)}"


@dataclass
class Query:
    """A parsed PQL string: one or more top-level calls."""

    calls: list[Call]

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)
