"""The rest of the unkeyed PQL surface in the port against the JAX package.

One data directory (index ``i`` over three shards: a set field ``f``, a
mutex field ``m``, a bool field ``b``, an int field ``amount`` and a time
field ``t``, written by ``pilosa_tpu``) answers through the JAX ``API``
(Pallas kernels in interpret mode) and the port's ``API`` on the CPU, in
the "off" configuration (each request alone, no tree compiler) and the
default one (the batcher, the tree compiler and the plan cache).  The
JSON must be equal byte for byte:

- every request of ``chip_smoke.py``'s mutex phase at a small size: a
  Count per mutex row, a selected pair, a compound Count over the mutex,
  bool and set fields, a filtered TopN, GroupBy over mutex x bool,
  ``Extract`` of set, mutex, bool and int fields, ``IncludesColumn`` and
  ``Options(shards=, excludeColumns=)``, and each call's argument errors;
- ``Store`` and ``ClearRow`` (with a no-op ``Store``, a ``Store`` into a
  mutex field and a ``ClearRow`` of a time field) with the same files
  afterwards;
- the Extract cap, Extract past the plane budget (one probe of the
  selected columns in each shard's fragment), ``Options(columnAttrs=)``
  and an Extract on a keyed index;
- ``column_bits`` and ``column_bits_grouped`` against the JAX functions;
- the plan cache's "generic" entries: hits on repeated compound Counts
  without the tree compiler, and a write to a dependency dropping them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.engine import kernels as jkernels
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import ApiError
from pilosa_tpu_torch.engine import kernels as tkernels
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec.executor import _UNPLANNABLE
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
SHARDS, MROWS = 3, 6
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}


def _write(root: str) -> dict:
    """Index ``i`` through ``pilosa_tpu``'s write path; returns columns
    the requests name (one in mutex row 3, one outside it)."""
    rng = np.random.default_rng(11)
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("m", JFO(type="mutex"))
    idx.create_field("b", JFO(type="bool"))
    idx.create_field("amount", JFO(type="int", min=-1000, max=1000))
    idx.create_field("t", JFO(type="time", time_quantum="YMD"))
    n = 3000
    cols = (rng.integers(0, SHARDS, n) * SW
            + rng.integers(0, 6000, n)).astype(np.uint64)
    idx.field("f").import_bits(rng.integers(0, 5, n).astype(np.uint64), cols)
    mcols = np.unique(cols)
    idx.field("m").import_bits(
        rng.integers(0, MROWS, len(mcols)).astype(np.uint64), mcols)
    # a second batch moves some columns to other rows (mutex clears)
    moved = rng.choice(mcols, 300, replace=False)
    idx.field("m").import_bits(
        rng.integers(0, MROWS, 300).astype(np.uint64), moved)
    bcols = rng.choice(mcols, len(mcols) * 3 // 4, replace=False)
    idx.field("b").import_bits(
        (rng.random(len(bcols)) < 2 / 3).astype(np.uint64), bcols)
    vcols = rng.choice(mcols, len(mcols) // 2, replace=False)
    idx.field("amount").import_values(
        vcols, rng.integers(-1000, 1001, len(vcols)).tolist())
    from datetime import datetime
    idx.field("t").import_bits(
        rng.integers(0, 3, 400).astype(np.uint64), cols[:400],
        [datetime(2021, 2, 1 + i % 20) for i in range(400)])
    idx.note_columns(cols)
    m3 = idx.field("m").standard_view().fragment(1).row(3).columns()
    m2 = idx.field("m").standard_view().fragment(2).row(2).columns()
    h.close()
    return {"in": SW + int(m3[5]), "out": 2 * SW + int(m2[0]),
            "b_true": None}


def _jax_api(root: str, monkeypatch, config: str):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    return holder, JAPI(holder, JExecutor(holder, plane_paging=False,
                                          kernel_tier="pallas",
                                          **CONFIGS[config]))


def _port_api(root: str, config: str, **kw):
    holder = THolder(root).open()
    return holder, TAPI(holder, TExecutor(holder, device="cpu",
                                          **CONFIGS[config], **kw))


def _answer(api, pql: str):
    try:
        return api.query("i", pql)["results"]
    except Exception as e:  # noqa: BLE001 — compared between packages
        return ("error", str(e))


def _same(japi, tapi, pql: str):
    want = _answer(japi, pql)
    got = _answer(tapi, pql)
    assert json.dumps(got) == json.dumps(want), pql
    return got


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("surface") / "data")
    return root, _write(root)


@pytest.fixture(scope="module", params=list(CONFIGS))
def apis(index, request):
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index[0], mp, request.param)
    th, tapi = _port_api(index[0], request.param)
    yield japi, tapi, index[1], request.param
    tapi.executor.close()
    th.close()
    jh.close()
    mp.undo()


COUNTS_M = "".join(f"Count(Row(m={r}))" for r in range(MROWS))
READS = [
    COUNTS_M,
    "Count(Row(m=1))Count(Row(m=4))",
    "Count(Intersect(Row(m=3), Row(b=true), Row(f=1)))",
    "TopN(m, Row(b=true), n=5)",
    "GroupBy(Rows(m), Rows(b))",
    ("Extract(Limit(Row(f=0), limit=40), Rows(f), Rows(m), Rows(b), "
     "Rows(amount))"),
    "Options(Count(Row(f=1)), shards=[0, 1])",
    "Options(Row(m=3), excludeColumns=true)",
    # the rest of the surface and the mutex and bool fields' reads
    "Extract(Row(f=2), Rows(m), Rows(amount), Rows(t), Rows(b))",
    "Extract(Intersect(Row(f=0), Row(f=1)), Rows(t))",
    "Extract(Row(f=99), Rows(m))",
    "Extract(Row(f=3))",
    "Options(Row(f=1), shards=[1])",
    "Options(Row(f=1), shards=[0], excludeColumns=true)",
    "Options(TopN(m, n=2), shards=[2])",
    "Options(Count(Row(f=1)), shards=[0])Count(Row(f=1))",
    "Options(Count(Row(m=2)), shards=[7])",
    "Options(Count(Row(f=1)), excludeColumns=true)",
    "Options(Rows(m), shards=[1])",
    "Row(m=2)",
    "Row(b=false)",
    "Count(Row(b=1))Count(Row(b=0))",
    "Rows(m)",
    "Rows(b)",
    "Rows(m, column=%d)" % (SW + 5),
    "TopN(b)",
    "TopN(m)",
    "Count(Not(Row(b=true)))",
    "Count(Union(Row(m=1), Row(m=2)))Count(Xor(Row(m=0), Row(f=0)))",
    "GroupBy(Rows(b), Rows(m), filter=Row(f=1))",
    "GroupBy(Rows(m), aggregate=Sum(field=amount))",
    "Count(Row(m=9))",
    # argument errors
    "Options(Row(f=1), Row(f=2))",
    "Options()",
    "IncludesColumn(Row(f=1))",
    "IncludesColumn(column=5)",
    "Extract()",
    "Extract(Row(f=1), Row(f=2))",
    "Extract(Row(f=1), Rows(nope))",
    "Row(b=2)",
    "Row(m=1, from=2021-01-01T00:00)",
]


@pytest.mark.parametrize("pql", READS)
def test_reads_equal(apis, pql):
    japi, tapi, _, _ = apis
    _same(japi, tapi, pql)


def test_includes_column_equal(apis):
    """A column inside the row, one outside it, one in another shard of
    the index and one outside the queried shards."""
    japi, tapi, cols, _ = apis
    got = [_same(japi, tapi, f"IncludesColumn(Row(m=3), column={c})")
           for c in (cols["in"], cols["out"], cols["in"] + 1, 9 * SW + 1)]
    assert got[0] == [True] and got[1] == [False] and got[3] == [False]
    assert _same(japi, tapi, "Options(IncludesColumn(Row(m=3), column="
                 f"{cols['in']}), shards=[0])") == [False]


def test_columnattrs_and_keyed_extract_equal(apis, tmp_path, monkeypatch):
    """``Options(columnAttrs=)`` (no attributes set: an empty map on a
    row result, nothing on a Count) and an Extract on a keyed index, which
    the first slices refused, answer what ``pilosa_tpu`` answers."""
    japi, tapi, _, _ = apis
    for pql in ("Options(Row(f=1), columnAttrs=true)",
                "Options(Count(Row(f=1)), columnAttrs=true)"):
        _same(japi, tapi, pql)
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    outs = []
    for name in ("jax", "port"):
        out = []
        root = str(tmp_path / name)
        if name == "jax":
            holder = JHolder(root).open()
            api = JAPI(holder, JExecutor(holder, plane_paging=False,
                                         kernel_tier="pallas"))
        else:
            holder = THolder(root).open()
            api = TAPI(holder, TExecutor(holder, device="cpu"))
        try:
            api.create_index("k", {"keys": True})
            api.create_field("k", "f")
            out.append(api.query("k", "Extract(All(), Rows(f))")["results"])
            api.import_bits("k", "f", row_ids=[1, 2, 2],
                            col_keys=["x", "y", "x"])
            out.append(api.query("k", "Extract(All(), Rows(f))")["results"])
        finally:
            api.executor.translate.close()
            if name == "port":
                api.executor.close()
            holder.close()
        outs.append(out)
    assert json.dumps(outs[1]) == json.dumps(outs[0])
    assert outs[1][1] == [{"fields": [{"name": "f", "type": "set"}],
                           "columns": [{"key": "x", "rows": [[1, 2]]},
                                       {"key": "y", "rows": [[2]]}]}]


def test_extract_cap_equal(apis, monkeypatch):
    """The cap is checked from the per-shard counts, with the reference's
    message, before anything is read."""
    japi, tapi, _, _ = apis
    monkeypatch.setattr(JExecutor, "MAX_EXTRACT_COLUMNS", 50)
    monkeypatch.setattr(TExecutor, "MAX_EXTRACT_COLUMNS", 50)
    got = _same(japi, tapi, "Extract(Row(f=0), Rows(m))")
    assert got[0] == "error" and "cap is 50" in got[1]
    _same(japi, tapi, "Extract(Limit(Row(f=0), limit=50), Rows(m))")


def test_extract_past_budget_equal(index, monkeypatch):
    """An executor whose budget the set planes exceed probes the selected
    columns in each shard's fragment instead of building the planes: the
    same table."""
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index[0], mp, "off")
    th, tapi = _port_api(index[0], "off", plane_budget=1 << 19)
    try:
        builds = tapi.executor.planes.builds
        for pql in ("Extract(Limit(Row(f=1), limit=30), Rows(f), Rows(m), "
                    "Rows(b))",
                    "Extract(ConstRow(columns=[1, 2, %d]), Rows(m), Rows(t))"
                    % (SW + 3)):
            _same(japi, tapi, pql)
        assert tapi.executor.planes.builds == builds
    finally:
        tapi.executor.close()
        th.close()
        jh.close()
        mp.undo()


# -- writes -----------------------------------------------------------------

WRITES = [
    "Store(Intersect(Row(f=1), Row(f=2)), f=40)",
    "Count(Row(f=40))",
    "Store(Intersect(Row(f=1), Row(f=2)), f=40)",      # no-op
    "Store(Row(m=2), f=1)",                            # replaces row 1
    "Count(Row(f=1))Count(Row(f=40))",
    "Store(Row(f=0), m=4)",                            # no mutex clears
    "Count(Row(m=4))Count(Row(m=0))",
    "Extract(Limit(Row(m=4), limit=10), Rows(m))",
    "Options(Store(Row(f=3), f=41), shards=[1])",
    "Count(Row(f=41))",
    "Store(Row(f=99), f=3)",                           # empties row 3
    "Count(Row(f=3))",
    "ClearRow(f=40)",
    "ClearRow(f=40)",                                  # nothing left
    "Count(Row(f=40))",
    "ClearRow(t=1)",                                   # time views keep it
    "Count(Row(t=1))",
    "Count(Row(t=1, from=2021-02-01T00:00, to=2021-03-01T00:00))",
    "ClearRow(b=true)",
    "Count(Row(b=1))",
    "Set(%d, m=5)" % (SW + 7),
    "Set(%d, b=false)" % (SW + 7),
    "Extract(ConstRow(columns=[%d]), Rows(m), Rows(b))" % (SW + 7),
    "Clear(%d, m=5)" % (SW + 7),
    "Count(Row(m=5))",
    "Set(%d, b=2)" % (SW + 8),
    "Store(f=3)",
    "Store(Row(f=1))",
    "ClearRow()",
    "Store(Row(f=1), amount=3)",
    "Count(Row(f=1))Count(Row(f=40))",
]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_writes_same_json_and_files(index, tmp_path, monkeypatch, config):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index[0], jdir)
    shutil.copytree(index[0], tdir)
    jh, japi = _jax_api(jdir, monkeypatch, config)
    th, tapi = _port_api(tdir, config)
    try:
        for pql in WRITES:
            _same(japi, tapi, pql)
    finally:
        tapi.executor.close()
        th.close()
        jh.close()
    jfiles, tfiles = _tree_files(jdir), _tree_files(tdir)
    assert sorted(tfiles) == sorted(jfiles)
    assert [k for k in jfiles if jfiles[k] != tfiles[k]] == []


# -- the plan cache ---------------------------------------------------------

COMPOUND = ("Count(Intersect(Row(m=3), Row(b=true), Row(f=1)))"
            "Count(Union(Row(m=1), Not(Row(b=false))))"
            "Count(Shift(Row(f=2), n=3))")


def test_generic_plans_hit_and_invalidate(index, tmp_path, monkeypatch):
    """Without the tree compiler a compound Count request is a "generic"
    entry: repeats hit it; a write to a dependency drops it and the next
    request plans again, with the reference's answers throughout."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index[0], jdir)
    shutil.copytree(index[0], tdir)
    jh, japi = _jax_api(jdir, monkeypatch, "off")
    th, tapi = _port_api(tdir, "off")
    ex = tapi.executor
    try:
        _same(japi, tapi, COMPOUND)
        (key, entry), = [(k, e) for k, e in ex._plans.items()
                         if k[1] == COMPOUND]
        assert entry.kind == "generic"
        hits = ex.serving_stats()["planCacheHits"]
        for _ in range(3):
            _same(japi, tapi, COMPOUND)
        assert ex.serving_stats()["planCacheHits"] == hits + 3
        assert ex._plans[key] is entry
        _same(japi, tapi, "Set(%d, b=true)" % (2 * SW + 1))
        _same(japi, tapi, COMPOUND)
        assert key not in ex._plans or ex._plans[key] is not entry
        _same(japi, tapi, COMPOUND)
        assert ex._plans[key].kind == "generic"
        # an Options request is never planned: its own shards answer
        _same(japi, tapi, "Options(Count(Row(m=3)), shards=[0])")
        _same(japi, tapi, "Count(Row(m=3))")
    finally:
        ex.close()
        th.close()
        jh.close()


VOLATILE = ("Count(Intersect(Row(f=1), Limit(Row(f=1), limit=40)))"
            "Count(Union(ConstRow(columns=[1, 2, %d]), Row(b=true)))"
            % (SW + 9))


def test_volatile_counts_not_planned(index, tmp_path, monkeypatch):
    """A Count over a volatile leaf (Limit's ranking, a ConstRow) is
    walked afresh on every request: the plan cache marks the query
    unplannable, and a write between requests shows in the next
    answer."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index[0], jdir)
    shutil.copytree(index[0], tdir)
    jh, japi = _jax_api(jdir, monkeypatch, "off")
    th, tapi = _port_api(tdir, "off")
    ex = tapi.executor
    try:
        before = _same(japi, tapi, VOLATILE)
        key, = [k for k in ex._plans if k[1] == VOLATILE]
        assert ex._plans[key] is _UNPLANNABLE
        assert before[0] == 40
        _same(japi, tapi, "ClearRow(f=1)")
        after = _same(japi, tapi, VOLATILE)
        assert after[0] == 0 and after[1] == before[1]
    finally:
        ex.close()
        th.close()
        jh.close()


# -- column probes ------------------------------------------------------------


def test_column_bits_equal():
    """The two gathers against the JAX functions on the same words, with
    the sign bit set in some words (the ``& 1`` after ``>>``)."""
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 1 << 32, (3, 5, 64), dtype=np.uint32)
    plane[:, :, 7] |= np.uint32(1 << 31)
    word_idx = rng.integers(0, 64, 9).astype(np.int32)
    word_idx[0] = 7
    bit_idx = rng.integers(0, 32, 9).astype(np.uint32)
    bit_idx[0] = 31
    tplane = torch.from_numpy(plane.view(np.int32))
    want = np.asarray(jkernels.column_bits(plane, word_idx, bit_idx))
    got = tkernels.column_bits(tplane, torch.from_numpy(word_idx),
                               torch.from_numpy(bit_idx.astype(np.int64)))
    assert (got.numpy() == want).all()
    gw = rng.integers(0, 64, (3, 9)).astype(np.int32)
    gb = rng.integers(0, 32, (3, 9)).astype(np.uint32)
    gw[1, 2], gb[1, 2] = 7, 31
    want = np.asarray(jkernels.column_bits_grouped(plane, gw, gb))
    got = tkernels.column_bits_grouped(tplane, torch.from_numpy(gw),
                                       torch.from_numpy(gb.astype(np.int64)),
                                       torch.arange(3))
    assert (got.numpy() == want).all()
    # over a subset of the shards: the same rows of the answer
    sel = tkernels.column_bits_grouped(
        tplane, torch.from_numpy(gw[[2, 0]]),
        torch.from_numpy(gb[[2, 0]].astype(np.int64)), torch.tensor([2, 0]))
    assert (sel.numpy() == want[[2, 0]]).all()
