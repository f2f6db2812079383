"""Mutex and bool fields in the port against the JAX package: the store,
REST, and the resident planes under their writes.

- mutex and bool ``import_bits`` (a column written twice in a batch,
  columns moving between rows over snapshot-resident, sparse and dense
  rows), ``set_bit``, ``clear_bit`` and ``clear_import``: the same files
  byte for byte (``.meta`` included) and the same journals; the bool
  row check's error;
- ``Fragment.set_row`` / ``clear_row`` (``Store`` / ``ClearRow``): the
  same op-log records, a no-op ``set_row`` writing none;
- the row probe a mutex import finds its clears with, against the rows'
  words, over array, bitmap and run containers;
- REST: creating mutex and bool fields, ``/import`` into them (a bool row
  above 1 answers the reference's 500) and ``/import-roaring`` refused
  with the reference's 400;
- which of absorb, fold or rebuild each write takes on a resident plane:
  a mutex import's cross-row clears absorb into the overlay (the old
  row's Count drops with no rebuild), a ``Store`` into a resident row
  and a ``ClearRow`` fold, a ``Store`` into a new row rebuilds.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import FieldOptions as TFO
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.store.fragment import Fragment as TFragment

SW = 1 << 20
SHARDS = 3


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# metas stamped with the wall time of their creation
_WALL_METAS = ("i/.meta", "i/_exists/.meta")


def _assert_same_files(jroot: str, troot: str,
                       skip=_WALL_METAS) -> None:
    jfiles, tfiles = _tree_files(jroot), _tree_files(troot)
    assert sorted(tfiles) == sorted(jfiles)
    assert [k for k in jfiles
            if k not in skip and jfiles[k] != tfiles[k]] == []


def _batch(rng, n: int, rows: int, width: int = 70_000):
    """``n`` (row, column) pairs over the shards, some columns twice."""
    cols = (rng.integers(0, SHARDS, n) * SW
            + rng.integers(0, width, n)).astype(np.uint64)
    cols[: n // 10] = cols[n // 10: 2 * (n // 10)]
    return rng.integers(0, rows, n).astype(np.uint64), cols


def _mutex_writes(holder_cls, fo_cls, root: str) -> dict:
    """The same writes through one package; returns the journals of the
    mutex field's shard-1 fragment since its first snapshot, the write
    results and the bool error."""
    rng = np.random.default_rng(21)
    h = holder_cls(root).open()
    idx = h.create_index("i")
    idx.create_field("m", fo_cls(type="mutex", created_at=1.0))
    idx.create_field("b", fo_cls(type="bool", created_at=1.0))
    m, b = idx.field("m"), idx.field("b")
    out = {"changed": []}
    rows, cols = _batch(rng, 6000, 5)
    out["changed"].append(m.import_bits(rows, cols))
    # row 6: a long run (a run container), row 7: >4096 bits in one
    # container (a bitmap container)
    run = np.arange(SW + 100, SW + 9000, dtype=np.uint64)
    out["changed"].append(m.import_bits(np.full(len(run), 6, np.uint64), run))
    dense = (SW + 70_000 + rng.choice(60_000, 6000, replace=False)
             ).astype(np.uint64)
    out["changed"].append(m.import_bits(np.full(len(dense), 7, np.uint64),
                                        dense))
    rows, cols = _batch(rng, 2000, 2)
    out["changed"].append(b.import_bits(rows, cols))
    for fld in (m, b):
        for frag in fld.standard_view().fragments.values():
            frag.snapshot()
    frag = m.standard_view().fragment(1)
    gen = frag.generation
    # moves over snapshot-resident rows: runs, bitmaps, arrays
    rows, cols = _batch(rng, 3000, 8)
    cols[:300] = run[rng.choice(len(run), 300, replace=False)]
    cols[300:600] = dense[rng.choice(len(dense), 300, replace=False)]
    out["changed"].append(m.import_bits(rows, cols))
    # and over materialized rows
    rows, cols = _batch(rng, 1500, 8)
    out["changed"].append(m.import_bits(rows, cols))
    out["changed"].append(m.set_bit(3, SW + 150))
    out["changed"].append(m.set_bit(3, SW + 150))
    out["changed"].append(m.clear_bit(3, SW + 150))
    out["changed"].append(m.clear_import(rows[:100], cols[:100]))
    out["changed"].append(b.set_bit(0, 2 * SW + 5))
    out["changed"].append(b.set_bit(1, 2 * SW + 5))
    rows, cols = _batch(rng, 500, 2)
    out["changed"].append(b.import_bits(rows, cols))
    with pytest.raises(ValueError) as e:
        b.import_bits(np.array([0, 2], np.uint64),
                      np.array([5, 6], np.uint64))
    out["bool_error"] = str(e.value)
    out["journal"] = frag.changed_cells_since(gen)
    rows, counts = np.unique(frag.positions() // np.uint64(SW),
                             return_counts=True)
    out["rows"] = dict(zip(rows.tolist(), counts.tolist()))
    h.close()
    return out


def test_mutex_bool_bytes_and_journals_equal(tmp_path):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    want = _mutex_writes(JHolder, JFO, jroot)
    got = _mutex_writes(THolder, TFO, troot)
    assert got == want
    assert want["bool_error"] == "bool field rows must be 0 or 1"
    assert want["journal"] is not None and len(want["journal"]) == 8
    _assert_same_files(jroot, troot)
    # each package reopens what the other wrote
    jh, th = JHolder(troot).open(), THolder(jroot).open()
    try:
        for s in range(SHARDS):
            jf = jh.index("i").field("m").standard_view().fragment(s)
            tf = th.index("i").field("m").standard_view().fragment(s)
            assert (tf.positions() == jf.positions()).all()
    finally:
        th.close()
        jh.close()


def _set_row_writes(frag_cls, path: str) -> tuple:
    frag = frag_cls(path, 0).open()
    rng = np.random.default_rng(4)
    frag.set_bits(np.repeat(np.arange(4, dtype=np.uint64), 500),
                  rng.integers(0, SW, 2000).astype(np.uint64))
    gen = frag.generation
    cols = np.unique(rng.integers(0, SW, 700)).astype(np.uint32)
    got = [frag.set_row(9, cols), frag.set_row(9, cols[::-1]),
           frag.set_row(2, cols[:10]), frag.set_row(5, np.empty(0)),
           frag.set_row(1, rng.integers(0, SW, 6000).astype(np.uint32)),
           frag.clear_row(3), frag.clear_row(3), frag.clear_row(77),
           frag.set_row(3, np.empty(0)), frag.generation]
    journal = frag.changed_cells_since(gen)
    frag.close()
    with open(path + ".oplog", "rb") as fh:
        oplog = fh.read()
    reopened = frag_cls(path, 0).open()
    return got, journal, oplog, reopened.positions()


def test_set_row_and_clear_row_records_equal(tmp_path):
    from pilosa_tpu.store.fragment import Fragment as JFragment
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = _set_row_writes(JFragment, str(tmp_path / "j" / "0"))
    got = _set_row_writes(TFragment, str(tmp_path / "t" / "0"))
    assert got[:2] == want[:2]
    assert got[0][1] is False and got[0][3] is False  # the no-ops
    assert got[2] == want[2]
    assert (got[3] == want[3]).all()
    with open(tmp_path / "j" / "0", "rb") as fj, \
            open(tmp_path / "t" / "0", "rb") as ft:
        assert fj.read() == ft.read()


def test_row_probe_matches_words(tmp_path):
    """``Fragment.rows_contain`` against ``row_words`` for snapshot rows
    in array, bitmap and run containers, for materialized sparse and
    dense rows, and for a row the fragment lacks."""
    rng = np.random.default_rng(8)
    path = str(tmp_path / "0")
    frag = TFragment(path, 0).open()
    frag.set_bits(np.zeros(3000, np.uint64),
                  rng.integers(0, SW, 3000).astype(np.uint64))
    frag.set_bits(np.ones(20_000, np.uint64),
                  rng.integers(0, 1 << 16, 20_000).astype(np.uint64))
    run = np.arange(5000, 30_000, dtype=np.uint64)
    frag.set_bits(np.full(len(run), 2, np.uint64), run)
    frag.snapshot()
    blob = open(path, "rb").read()[TFragment._SNAP_HDR.size:]
    types = set(troaring.Directory(blob).types.tolist())
    assert types == {troaring.TYPE_ARRAY, troaring.TYPE_BITMAP,
                     troaring.TYPE_RUN}
    probe = np.concatenate([rng.integers(0, SW, 4000),
                            np.arange(4990, 5010), np.arange(29990, 30010),
                            [0, SW - 1]]).astype(np.uint32)

    def check():
        rows = [3, 0, 1, 2, 9]
        got = frag.rows_contain(rows, probe)
        for i, r in enumerate(rows):
            words = frag.row_words(r)
            want = (words[probe >> 5] >> (probe & 31)) & 1 != 0
            assert (got[i] == want).all(), r

    check()                       # snapshot-resident rows
    frag.set_bits(np.array([0, 1, 2], np.uint64),
                  np.array([7, 8, 9], np.uint64))
    assert frag.dense or frag.rows
    check()                       # materialized rows
    frag.close()


# -- REST -------------------------------------------------------------------


def _request(base: str, path: str, body: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax_api(root: str, monkeypatch, **kw):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    return holder, JAPI(holder, JExecutor(holder, plane_paging=False,
                                          kernel_tier="pallas", **kw))


def test_rest_mutex_and_bool_equal(tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jh, japi = _jax_api(jdir, monkeypatch)
    th = THolder(tdir).open()
    tapi = TAPI(th, TExecutor(th, device="cpu"))
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    rng = np.random.default_rng(6)
    try:
        bases = ("http://%s:%d" % js.address, "http://%s:%d" % ts.address)

        def both(path, body):
            raw = json.dumps(body).encode() if isinstance(body, dict) \
                else body
            got = [_request(b, path, raw) for b in bases]
            assert got[1] == got[0], path
            return got[0]

        both("/index/i", {})
        for name, typ in (("m", "mutex"), ("b", "bool")):
            assert both(f"/index/i/field/{name}",
                        {"options": {"type": typ}})[0] == 200
        cols = rng.integers(0, SHARDS * SW, 3000).tolist()
        assert both("/index/i/field/m/import",
                    {"rowIDs": rng.integers(0, 6, 3000).tolist(),
                     "columnIDs": cols})[0] == 200
        assert both("/index/i/field/m/import",
                    {"rowIDs": rng.integers(0, 6, 500).tolist(),
                     "columnIDs": cols[:500]})[0] == 200
        assert both("/index/i/field/m/import",
                    {"rowIDs": [1, 2], "columnIDs": cols[:2],
                     "clear": True})[0] == 200
        assert both("/index/i/field/b/import",
                    {"rowIDs": rng.integers(0, 2, 800).tolist(),
                     "columnIDs": cols[:800]})[0] == 200
        status, body = both("/index/i/field/b/import",
                            {"rowIDs": [0, 2], "columnIDs": [1, 2]})
        assert status == 500 and "rows must be 0 or 1" in body["error"]
        # any other bad batch is the port's 400, on a bool field as on a
        # mutex one
        for name in ("m", "b"):
            status, body = _request(
                bases[1], f"/index/i/field/{name}/import", json.dumps(
                    {"rowIDs": [1 << 41], "columnIDs": [1],
                     "clear": True}).encode())
            assert status == 400 and "out of range" in body["error"], body
        blob = jroaring.serialize(np.array([1, SW + 5], np.uint64))
        for name in ("m", "b"):
            status, body = both(f"/index/i/field/{name}/import-roaring/0",
                                blob)
            assert status == 400 and "use the pair import" in body["error"]
        for pql in ("".join(f"Count(Row(m={r}))" for r in range(6)),
                    "TopN(m)", "Count(Row(b=true))Count(Row(b=false))",
                    "GroupBy(Rows(b), Rows(m))", "Rows(m)"):
            want = both("/index/i/query", pql.encode())
            assert want[0] == 200, pql
    finally:
        ts.close()
        js.close()
        tapi.executor.close()
        th.close()
        jh.close()
    for name in ("m", "b"):
        with open(os.path.join(jdir, "i", name, ".meta")) as fj, \
                open(os.path.join(tdir, "i", name, ".meta")) as ft:
            jm, tm = json.load(fj), json.load(ft)
        assert jm.pop("created_at") and tm.pop("created_at")
        assert tm == jm
    _assert_same_files(jdir, tdir, skip=_WALL_METAS
                       + ("i/m/.meta", "i/b/.meta"))


# -- resident planes ----------------------------------------------------------

COUNTS_M = "".join(f"Count(Row(m={r}))" for r in range(8))


@pytest.mark.parametrize("config", ["off", "default"])
def test_writes_reach_resident_planes(tmp_path, monkeypatch, config):
    """Each write's path on a resident plane, with the reference's
    answers after it: a mutex import (the old rows' Counts drop through
    the overlay, no build), a Store into a resident row and a ClearRow
    (folds), a Store into a new row (rebuilds), and a GroupBy rows plane
    refreshed from the journals after the mutex import."""
    kw = ({"count_batch_window": "off", "tree_fusion": False}
          if config == "off" else {})
    root = str(tmp_path / "data")
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("m", JFO(type="mutex"))
    idx.create_field("b", JFO(type="bool"))
    rng = np.random.default_rng(9)
    cols = np.unique(rng.integers(0, SHARDS * SW, 20_000)).astype(np.uint64)
    idx.field("m").import_bits(
        rng.integers(0, 8, len(cols)).astype(np.uint64), cols)
    idx.field("b").import_bits(
        rng.integers(0, 2, len(cols)).astype(np.uint64), cols)
    idx.field("f").import_bits(
        rng.integers(0, 4, len(cols)).astype(np.uint64), cols)
    h.close()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(root, jdir)
    shutil.copytree(root, tdir)
    jh, japi = _jax_api(jdir, monkeypatch, **kw)
    th = THolder(tdir).open()
    tapi = TAPI(th, TExecutor(th, device="cpu", **kw))
    planes = tapi.executor.planes
    gb = "GroupBy(Rows(m), Rows(b))"

    def same(pql):
        want = japi.query("i", pql)["results"]
        assert tapi.query("i", pql)["results"] == want, pql
        return want

    def path_of(write, reads):
        b0, a0, f0 = (planes.builds, planes.delta_absorbs,
                      planes.incremental_applied)
        same(write)
        for pql in reads:
            same(pql)
        return (planes.builds - b0, planes.delta_absorbs - a0,
                planes.incremental_applied - f0)

    try:
        before = same(COUNTS_M)
        same(gb)
        # every moved column leaves its old row: the old rows drop
        moved = cols[:400]
        new_rows = [int(r) for r in rng.integers(0, 8, 400)]
        body = {"rowIDs": new_rows, "columnIDs": moved.tolist()}
        for api in (japi, tapi):
            api.import_bits("i", "m", row_ids=body["rowIDs"],
                            col_ids=body["columnIDs"])
        b0, a0 = planes.builds, planes.delta_absorbs
        after = same(COUNTS_M)
        assert (planes.builds, planes.delta_absorbs) == (b0, a0 + 1)
        assert after != before and sum(after) == sum(before)
        r0 = planes.incremental_applied
        same(gb)
        assert planes.builds == b0 and planes.incremental_applied > r0
        # a Store into a resident row and a ClearRow fold; a Store into
        # a row the plane lacks rebuilds it
        assert path_of("Store(Row(b=true), m=2)", [COUNTS_M])[0] == 0
        assert path_of("ClearRow(m=5)", [COUNTS_M])[0] == 0
        assert path_of("Store(Row(f=1), m=40)",
                       [COUNTS_M + "Count(Row(m=40))"])[0] == 1
    finally:
        tapi.executor.close()
        th.close()
        jh.close()
