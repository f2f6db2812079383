"""Whole-tree compilation in the port, against the JAX package.

The same PQL trees lower through ``pilosa_tpu.exec.tree`` and
``pilosa_tpu_torch.exec.tree`` over the same data directory; the same
numpy words, made from a seed, fold through both packages' ``tree_fold``,
overlay helpers (``overlay_gathered_rows``, ``overlay_row``),
``assemble_items`` and ``FusedCache.run_tree_counts`` /
``run_tree_words``.  Everything is an exact integer word or count: the
tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.engine import kernels as jk
from pilosa_tpu.exec import tree as jtree
from pilosa_tpu.exec.executor import ExecutionError as JExecutionError
from pilosa_tpu.exec.executor import Executor as JExecutor
from pilosa_tpu.exec.executor import _Ctx as JCtx
from pilosa_tpu.exec.fused import FusedCache as JFused
from pilosa_tpu.exec.fused import Unfusable as JUnfusable
from pilosa_tpu.ingest import delta as jdelta
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec import tree as ttree
from pilosa_tpu_torch.exec.executor import ExecutionError as TExecutionError
from pilosa_tpu_torch.exec.executor import Executor as TExecutor
from pilosa_tpu_torch.exec.executor import _Ctx as TCtx
from pilosa_tpu_torch.exec.fused import FusedCache as TFused
from pilosa_tpu_torch.exec.fused import Unfusable as TUnfusable
from pilosa_tpu_torch.ingest import delta as tdelta
from pilosa_tpu_torch.pql.parser import parse as tparse
from pilosa_tpu_torch.store import Holder as THolder
from test_torch_slice import SHARDS, _write_index

EDGE = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0, 1], np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/int numpy -> the port's int32 tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _words(rng, shape) -> np.ndarray:
    """~25% dense uint32 words with the sign-bit and all-ones words
    planted along the last axis."""
    w = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=shape, dtype=np.uint32))
    w[..., :len(EDGE)] = EDGE
    return w


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

TREES = [
    "Intersect(Row(f=1), Union(Row(f=2), Row(f=5)), Row(g=0))",
    # CSE: a repeated anchor row, a repeated other-field row, exists twice
    "Union(Row(f=1), Intersect(Row(f=1), Row(f=2)), Row(g=0), Row(g=0))",
    "Intersect(Not(Row(f=1)), Not(Row(f=2)), All())",
    "Intersect(Row(f=1), Row(f=99))",                 # an absent row
    "Union(Row(f=1), Union())",
    "Difference(Row(f=3))",                           # one child
    "Not(Row(f=1))",
    "Xor(Difference(Row(f=1), Row(g=1)), Not(Row(h=0)))",
    "Union(" + ", ".join(f"Row(f={r})" for r in range(8))
    + ", Row(g=0), Row(g=1), Row(h=2))",              # wide and flat
    "Intersect(All(), Row(f=2))",
]
# shapes neither package lowers: too deep, no anchor row
UNFUSABLE = [
    "".join("Intersect(Row(f=1), " for _ in range(9)) + "Row(f=2)" + ")" * 9,
    "Union(All(), Not(All()))",
    "Union()",
]
# the static ops (Shift, Limit), literal rows (ConstRow) and data-chosen
# row sets (UnionRows)
STATIC_LEAVES = ["Intersect(Row(f=1), Shift(Row(f=2), n=1))",
                 "Union(Row(f=1), Limit(Row(f=2), limit=3))",
                 "Intersect(Row(f=1), ConstRow(columns=[1, 2]))",
                 "Intersect(Row(f=1), UnionRows(Rows(f)))"]


@pytest.fixture(scope="module")
def executors(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "data")
    _write_index(root)
    jh, th = JHolder(root).open(), THolder(root).open()
    jex = JExecutor(jh, count_batch_window="off", plane_paging=False)
    tex = TExecutor(th, device="cpu", count_batch_window="off")
    yield jex, tex
    th.close()
    jh.close()


def _lower(ex, ctx_cls, parse, holder_index, pql):
    ctx = ctx_cls(holder_index, tuple(range(SHARDS)))
    call = parse(pql).calls[0]
    mod = jtree if ctx_cls is JCtx else ttree
    return mod.lower_count_tree(ex, ctx, call)


@pytest.mark.parametrize("pql", TREES)
def test_lowering_equal(executors, pql):
    jex, tex = executors
    want = _lower(jex, JCtx, jparse, jex.holder.index("i"), pql)
    got = _lower(tex, TCtx, tparse, tex.holder.index("i"), pql)
    for name in ("field", "rows", "extras", "prog", "depth", "cse_hits"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("pql", UNFUSABLE)
def test_unfusable_alike(executors, pql):
    jex, tex = executors
    with pytest.raises(JUnfusable):
        _lower(jex, JCtx, jparse, jex.holder.index("i"), pql)
    with pytest.raises(TUnfusable):
        _lower(tex, TCtx, tparse, tex.holder.index("i"), pql)


@pytest.mark.parametrize("pql", STATIC_LEAVES)
def test_leaves_not_ported_refused(executors, pql):
    """Shift, Limit, ConstRow and UnionRows lower as the reference lowers
    them (static ops carry their arguments in the program; a UnionRows
    spec is volatile), and their Counts answer alike."""
    jex, tex = executors
    want = _lower(jex, JCtx, jparse, jex.holder.index("i"), pql)
    got = _lower(tex, TCtx, tparse, tex.holder.index("i"), pql)
    for name in ("field", "rows", "extras", "prog", "depth", "cse_hits",
                 "volatile"):
        assert getattr(got, name) == getattr(want, name), name
    assert tex.execute("i", f"Count({pql})") == \
        jex.execute("i", f"Count({pql})")


def test_not_without_existence_alike(tmp_path):
    """On an index that does not track existence, ``Not`` is a query
    error with the same text in both packages."""
    root = str(tmp_path)
    jh = JHolder(root).open()
    jh.create_index("x", track_existence=False).create_field("f")
    jh.close()
    jh, th = JHolder(root).open(), THolder(root).open()
    try:
        jex = JExecutor(jh, count_batch_window="off", plane_paging=False)
        tex = TExecutor(th, device="cpu", count_batch_window="off")
        with pytest.raises(JExecutionError) as je:
            jtree.lower_count_tree(jex, JCtx(jh.index("x"), (0,)),
                                   jparse("Not(Row(f=1))").calls[0])
        with pytest.raises(TExecutionError) as te:
            ttree.lower_count_tree(tex, TCtx(th.index("x"), (0,)),
                                   tparse("Not(Row(f=1))").calls[0])
        assert str(te.value) == str(je.value)
    finally:
        th.close()
        jh.close()


# ---------------------------------------------------------------------------
# folds and helpers
# ---------------------------------------------------------------------------

P, X, Z, N = jk.TREE_PUSH, jk.TREE_PUSHX, jk.TREE_ZERO, jk.TREE_NOP
AND, OR, ANDNOT, XOR = jk.TREE_AND, jk.TREE_OR, jk.TREE_ANDNOT, jk.TREE_XOR
# (skeleton, row args, extra args): every opcode
PROGRAMS = [
    ((P, P, AND), (0, 1), ()),
    ((P, P, OR), (2, 0), ()),
    ((P, P, ANDNOT), (1, 3), ()),
    ((P, P, XOR), (3, 3), ()),
    ((X, P, ANDNOT), (2,), (1,)),
    ((P, Z, OR, N, N), (1,), ()),
    ((Z,), (), ()),
    ((P, X, X, OR, P, XOR, AND), (0, 3), (0, 1)),
    ((P,), (2,), ()),
]


def test_opcodes_equal():
    for name in ("TREE_NOP", "TREE_PUSH", "TREE_PUSHX", "TREE_ZERO",
                 "TREE_AND", "TREE_OR", "TREE_ANDNOT", "TREE_XOR",
                 "TREE_STACK_DEPTH", "TREE_STATIC_OPS"):
        assert getattr(tk, name) == getattr(jk, name), name
    assert ttree.TREE_MAX_PROG == jtree.TREE_MAX_PROG
    assert ttree._OP_CODE == jtree._OP_CODE
    assert ttree.TREE_CALLS == jtree.TREE_CALLS


@pytest.mark.parametrize("prog", PROGRAMS)
def test_tree_fold_equal(prog):
    skeleton, row_args, extra_args = prog
    rng = np.random.default_rng(len(skeleton) * 31 + sum(row_args))
    rows = _words(rng, (4, 3, 96))
    extras = _words(rng, (2, 3, 96))
    want = jk.tree_fold(jnp.asarray(rows), skeleton,
                        jnp.asarray(row_args or (0,), jnp.int32),
                        jnp.asarray(extras),
                        jnp.asarray(extra_args or (0,), jnp.int32))
    got = tk.tree_fold(_t(rows), skeleton, list(row_args),
                       [_t(e) for e in extras], list(extra_args))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    # the solo form: rows read through a callable off a plane
    plane = np.moveaxis(rows, 0, 1)            # [S, G, W]
    tplane = _t(plane)
    got = tk.tree_fold(lambda a: tplane[:, a], skeleton, list(row_args),
                       [_t(e) for e in extras], list(extra_args),
                       zero=torch.zeros((3, 96), dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_assemble_items_equal():
    a, b, c = object(), object(), object()
    items = [((4, 1), ((P, 0), (P, 1), (AND, 0), (X, 0), (OR, 0)), (a,)),
             ((1, 7), ((P, 1), (X, 1), (ANDNOT, 0)), (b, a)),
             ((), ((Z, 0), (X, 0), (OR, 0)), (c,)),
             ((7, 4, 2), ((P, 2), (P, 0), (XOR, 0)), ())]
    want = jtree.assemble_items(items)
    got = ttree.assemble_items(items)
    assert got[0] == want[0] and got[1] == want[1]
    assert [id(e) for e in got[2]] == [id(e) for e in want[2]]


def _overlay(seed: int, s: int, r: int, w: int, n: int, c_pad: int):
    """``n`` live cells (0x80000000, 0xFFFFFFFF and 0 values among them)
    padded to ``c_pad`` lanes with the out-of-range flat row ``s * r``."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(s * r * w, n, replace=False)
    rows = np.full(c_pad, s * r, np.int32)
    words = np.zeros(c_pad, np.int32)
    vals = np.zeros(c_pad, np.uint32)
    rows[:n], words[:n] = cells // w, cells % w
    vals[:n] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    vals[0], vals[1], vals[2] = 0x80000000, 0xFFFFFFFF, 0
    return rows, words, vals


@pytest.mark.parametrize("row_idx", [(2, 0, 3, 0), (1,), (3, 2, 1, 0, 0, 0)])
def test_overlay_gathered_rows_equal(row_idx):
    s, r, w = 3, 4, 40
    rng = np.random.default_rng(len(row_idx))
    plane = _words(rng, (s, r, w))
    rows, words, vals = _overlay(5, s, r, w, 30, 32)
    idx = np.asarray(row_idx, np.int32)
    want = jdelta.overlay_gathered_rows(
        jnp.take(jnp.asarray(plane), jnp.asarray(idx), axis=-2),
        jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(words),
        jnp.asarray(vals), r)
    sel = _t(plane).index_select(1, torch.from_numpy(idx).long())
    got = tdelta.overlay_gathered_rows(sel, _t(idx), _t(rows), _t(words),
                                       _t(vals), r)
    assert got is sel                          # in place on the gather
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))     # pad lanes too


@pytest.mark.parametrize("slot", range(4))
def test_overlay_row_equal(slot):
    s, r, w = 3, 4, 40
    plane = _words(np.random.default_rng(9), (s, r, w))
    rows, words, vals = _overlay(6, s, r, w, 30, 32)
    want = jdelta.overlay_row(jnp.asarray(plane)[:, slot], slot,
                              jnp.asarray(rows), jnp.asarray(words),
                              jnp.asarray(vals), r)
    tplane = _t(plane)
    got = tdelta.overlay_row(tplane[:, slot], slot, _t(rows), _t(words),
                             _t(vals), r)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert torch.equal(tplane, _t(plane))      # the plane is untouched


def test_overlay_without_live_cells_is_identity():
    s, r, w = 2, 4, 16
    plane = _words(np.random.default_rng(3), (s, r, w))
    rows, words, vals = _overlay(7, s, r, w, 0, 4)   # pad lanes only
    idx = torch.tensor([1, 3])
    sel = _t(plane).index_select(1, idx)
    want = sel.clone()
    tdelta.overlay_gathered_rows(sel, idx, _t(rows), _t(words), _t(vals), r)
    assert torch.equal(sel, want)
    got = tdelta.overlay_row(_t(plane)[:, 2], 2, _t(rows), _t(words),
                             _t(vals), r)
    assert torch.equal(got, _t(plane)[:, 2])


# (slots, programs): PUSH args index slots, PUSHX args the extras
WINDOWS = [
    ((5,), [((P, 0), (X, 0), (AND, 0))]),
    ((3, 0, 6), [((P, 0), (P, 1), (OR, 0), (X, 1), (ANDNOT, 0)),
                 ((P, 2), (P, 0), (XOR, 0)),
                 ((X, 0), (P, 1), (ANDNOT, 0), (Z, 0), (OR, 0)),
                 ((P, 1),)]),
]


@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
def test_run_tree_counts_equal(window, with_delta):
    slots, progs = window
    s, r, w = 3, 8, 64
    rng = np.random.default_rng(len(progs) + with_delta)
    plane = _words(rng, (s, r, w))
    extras = [_words(rng, (s, w)) for _ in range(2)]
    jd = td = None
    if with_delta:
        rows, words, vals = _overlay(11, s, r, w, 40, 64)
        jd = jdelta.DeltaOverlay(jnp.asarray(rows), jnp.asarray(words),
                                 jnp.asarray(vals), n=40, bits=0)
        td = tdelta.DeltaOverlay(_t(rows), _t(words), _t(vals), n=40,
                                 bits=0)
    progs = tuple(tuple(p) for p in progs)
    want = JFused().run_tree_counts(
        jnp.asarray(plane), slots, progs,
        tuple(jnp.asarray(e) for e in extras), delta=jd)
    got = TFused().run_tree_counts(_t(plane), slots, progs,
                                   tuple(_t(e) for e in extras), delta=td)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if len(progs) == 1:
        want = JFused().run_tree_words(
            jnp.asarray(plane), slots, progs[0],
            tuple(jnp.asarray(e) for e in extras), delta=jd)
        got = TFused().run_tree_words(_t(plane), slots, progs[0],
                                      tuple(_t(e) for e in extras),
                                      delta=td)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
