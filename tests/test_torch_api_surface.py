"""The rest of the single-node REST surface in the port against the JAX
package, on copies of one data directory written by ``pilosa_tpu``:

- ``GET /index/{i}``, ``GET /index/{i}/field/{f}``, ``/schema``,
  ``/info``, ``/version`` and ``/export`` (set, time, mutex, bool, int,
  decimal and keyed fields), their error bodies, byte for byte;
- ``DELETE`` of an index and of a field, keyed and unkeyed, then the
  same index or field recreated and written: the answers, the files and
  the key stores' ids are equal;
- a delete while a background plane build of the field writes its
  ``.dense`` images and while the holder's compaction queue holds (and
  runs) its fragments: the delete waits for both, nothing is published or
  written under the deleted path afterwards, and the recreated field
  answers exactly;
- queries racing a delete answer exactly or the reference's 404;
- ``/import-roaring`` into a view of any name: equal files.
"""

import json
import os
import shutil
import threading
import time
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
from pilosa_tpu.store.translate import TranslateStore as JTranslate
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import ApiError
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store.fragment import Fragment as TFragment
from pilosa_tpu_torch.store.translate import TranslateStore as TTranslate

SW = 1 << 20
SHARDS = 3


def _write(root: str) -> None:
    """Index ``i`` (set ``f``, time ``t``, mutex ``m``, bool ``b``, int
    ``amount``, decimal ``dec``) over three shards and keyed index ``k``
    (keyed set ``f``, id-row set ``g``, int ``spend``), through the JAX
    package's write path."""
    from datetime import datetime
    rng = np.random.default_rng(5)
    h = JHolder(root).open()
    api = JAPI(h, JExecutor(h, plane_paging=False))
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("t", JFO(type="time", time_quantum="YMD"))
    idx.create_field("m", JFO(type="mutex"))
    idx.create_field("b", JFO(type="bool"))
    idx.create_field("amount", JFO(type="int", min=-1000, max=1000))
    idx.create_field("dec", JFO(type="decimal", scale=2, min=-100, max=100))
    n = 2500
    cols = (rng.integers(0, SHARDS, n) * SW
            + rng.integers(0, 5000, n)).astype(np.uint64)
    idx.field("f").import_bits(rng.integers(0, 6, n).astype(np.uint64), cols)
    idx.field("t").import_bits(
        rng.integers(0, 3, 300).astype(np.uint64), cols[:300],
        [datetime(2021, 2, 1 + i % 10) for i in range(300)])
    ucols = np.unique(cols)
    idx.field("m").import_bits(
        rng.integers(0, 4, len(ucols)).astype(np.uint64), ucols)
    idx.field("b").import_bits(
        (rng.random(len(ucols)) < 0.5).astype(np.uint64), ucols)
    vcols = ucols[::2]
    idx.field("amount").import_values(
        vcols, rng.integers(-1000, 1001, len(vcols)).tolist())
    idx.field("dec").import_values(
        vcols[:200], [round(float(x), 2) for x in
                      rng.uniform(-100, 100, 200)])
    idx.note_columns(cols)
    api.create_index("k", {"keys": True})
    api.create_field("k", "f", {"keys": True})
    api.create_field("k", "g")
    api.create_field("k", "spend", {"type": "int", "min": 0, "max": 500})
    keys = [f"user-{i:05d}" for i in range(900)]
    api.import_bits("k", "f", col_keys=keys,
                    row_keys=[f"seg-{i % 7}" for i in range(900)])
    api.import_bits("k", "g", col_keys=keys[:400],
                    row_ids=[i % 3 for i in range(400)])
    api.import_values("k", "spend", col_keys=keys[100:600],
                      values=[i % 501 for i in range(500)])
    api.executor.translate.close()
    h.close()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("surface12") / "data")
    _write(root)
    return root


def _copy(index_dir: str, dst) -> str:
    root = str(dst)
    shutil.copytree(index_dir, root)
    return root


class _Pair:
    """One copy of the directory served by each package, API and REST."""

    def __init__(self, index_dir: str, tmp_path, **texec):
        self.jroot = _copy(index_dir, tmp_path / "j")
        self.troot = _copy(index_dir, tmp_path / "t")
        self.jh = JHolder(self.jroot).open()
        self.th = THolder(self.troot).open()
        self.japi = JAPI(self.jh, JExecutor(self.jh, plane_paging=False))
        self.tapi = TAPI(self.th, TExecutor(self.th, device="cpu", **texec))
        self.js = JServer(self.japi, "127.0.0.1", 0).start()
        self.ts = TServer(self.tapi, "127.0.0.1", 0).start()
        self.closed = False

    def bases(self):
        return ["http://%s:%d" % s.address for s in (self.js, self.ts)]

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.js.close()
        self.ts.close()
        self.japi.executor.translate.close()
        self.tapi.executor.close()
        self.jh.close()
        self.th.close()


@pytest.fixture
def pair(index_dir, tmp_path):
    p = _Pair(index_dir, tmp_path)
    yield p
    p.close()


def _http(base: str, method: str, path: str, body: bytes | None = None):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _same(pair, method: str, path: str, body: bytes | None = None):
    j, t = (_http(b, method, path, body) for b in pair.bases())
    assert t == j, (path, t[:2], t[2][:200], j[2][:200])
    return t


@pytest.mark.parametrize("path", [
    "/index/i", "/index/k", "/index/i/field/f", "/index/i/field/dec",
    "/index/k/field/spend", "/index/nope", "/index/i/field/nope",
    "/index/nope/field/f", "/schema", "/info", "/version"])
def test_get_routes_equal(pair, path):
    status, ctype, body = _same(pair, "GET", path)
    assert ctype == "application/json"
    if path == "/version":
        assert json.loads(body) == {"version": "0.1.0"}


@pytest.mark.parametrize("index, field", [
    ("i", "f"), ("i", "t"), ("i", "m"), ("i", "b"), ("i", "amount"),
    ("i", "dec"), ("i", "_exists"), ("k", "f"), ("k", "g"), ("k", "spend"),
    ("i", "nope"), ("nope", "f")])
def test_export_equal(pair, index, field):
    status, ctype, body = _same(pair, "GET",
                                f"/export?index={index}&field={field}")
    if field != "nope" and index != "nope":
        assert status == 200 and ctype == "text/csv" and body
    else:
        assert status == 404


def test_export_missing_params_and_empty_keyed_store(pair):
    _same(pair, "GET", "/export?index=i")
    # a keyed index whose column store is empty writes column ids
    for api in (pair.japi, pair.tapi):
        api.create_index("e", {"keys": True})
        api.create_field("e", "f")
    for api in (pair.japi, pair.tapi):
        api.holder.index("e").field("f").import_bits(
            np.array([1, 2], np.uint64), np.array([5, SW + 7], np.uint64))
    status, _, body = _same(pair, "GET", "/export?index=e&field=f")
    assert body == b"1,5\n2,1048583\n"


def test_export_matches_a_row_scan(pair):
    """The vectorized export against the reference's row-by-row loop
    (each row's columns, shard by shard) on the port's own fragments."""
    f = pair.th.index("i").field("f")
    view = f.standard_view()
    want = []
    for shard in sorted(view.fragments):
        frag = view.fragment(shard)
        for r in frag.row_ids():
            words = frag.row_words(r)
            cols = np.flatnonzero(np.unpackbits(
                words.view(np.uint8), bitorder="little"))
            want += [f"{r},{int(c) + shard * SW}\n" for c in cols]
    assert pair.tapi.export_csv("i", "f") == "".join(want)


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_same_trees(jroot: str, troot: str) -> None:
    """Equal file sets; equal bytes but for metas (stamped with the time
    of their creation) and sqlite key stores (compared by ids)."""
    jf, tf = _tree_files(jroot), _tree_files(troot)
    assert sorted(tf) == sorted(jf)
    diff = [k for k in jf if jf[k] != tf[k]
            and not k.endswith(".meta") and ".sqlite" not in k]
    assert diff == []


def _ids(mod, root: str, index: str, field: str | None, keys: list):
    ts = mod(root)
    try:
        store = ts.columns(index) if field is None else ts.rows(index, field)
        return store.translate(keys)
    finally:
        ts.close()


@pytest.mark.parametrize("what", ["index", "keyed index", "field",
                                  "keyed field", "bsi field"])
def test_delete_then_recreate_equal(pair, what):
    """DELETE over REST, the 404s that follow, the same index or field
    recreated and written: answers, trees and key ids equal."""
    index = "k" if "keyed" in what else "i"
    field = {"field": "f", "keyed field": "f", "bsi field": "amount"}.get(
        what)
    path = f"/index/{index}" + (f"/field/{field}" if field else "")
    # plane and plan caches warm before the delete
    for q in ("Count(Row(f=1))", "TopN(f, n=3)"):
        if index == "i":
            _same(pair, "POST", "/index/i/query", q.encode())
    if index == "k":
        _same(pair, "POST", "/index/k/query", b'Count(Row(f="seg-1"))')
    assert _same(pair, "DELETE", path)[0] == 200
    assert not os.path.exists(os.path.join(pair.troot, index,
                                           field or ""))
    ex = pair.tapi.executor
    assert not [k for k in ex.planes._entries if k[1] == index]
    assert not [k for k in ex._plans if k[0] == index]
    assert not [k for k in ex.translate._logs if k[0] == index
                and (field is None or k[1] == field)]
    assert _same(pair, "DELETE", path)[0] == 404
    q = (b'Count(Row(f="seg-1"))' if index == "k" else b"Count(Row(f=1))")
    if field == "amount":
        q = b"Sum(field=amount)"
    assert _same(pair, "POST", f"/index/{index}/query", q)[0] in (400, 404)
    if field is None:
        opts = {"keys": index == "k"}
        _same(pair, "POST", f"/index/{index}",
              json.dumps({"options": opts}).encode())
    if field == "amount":
        fopts = {"type": "int", "min": -50, "max": 50}
    else:
        fopts = {"keys": index == "k"}
    _same(pair, "POST", f"/index/{index}/field/{field or 'f'}",
          json.dumps({"options": fopts}).encode())
    fname = field or "f"
    if field == "amount":
        body = {"columnIDs": [3, SW + 4, 2 * SW + 5], "values": [-7, 9, 50]}
        _same(pair, "POST", "/index/i/field/amount/importValue",
              json.dumps(body).encode())
        reads = [b"Sum(field=amount)", b"Min(field=amount)",
                 b"Count(Range(amount > 0))"]
    elif index == "k":
        body = {"rowKeys": ["seg-new", "seg-1", "seg-new"],
                "columnKeys": ["user-new", "user-00001", "user-00002"]}
        _same(pair, "POST", f"/index/k/field/{fname}/import",
              json.dumps(body).encode())
        reads = [b'Count(Row(f="seg-new"))', b'Count(Row(f="seg-1"))',
                 b"TopN(f, n=3)", b'Row(f="seg-new")']
    else:
        body = {"rowIDs": [1, 1, 4], "columnIDs": [10, SW + 11, 2 * SW]}
        _same(pair, "POST", f"/index/i/field/{fname}/import",
              json.dumps(body).encode())
        reads = [b"Count(Row(f=1))", b"TopN(f, n=3)", b"Row(f=4)"]
    for r in reads:
        status, _, got = _same(pair, "POST", f"/index/{index}/query", r)
        assert status == 200, got
    _same(pair, "GET", f"/export?index={index}&field={fname}")
    pair.close()
    _assert_same_trees(pair.jroot, pair.troot)
    if index == "k":
        keys = ["user-new", "user-00001", "user-00002", "user-00899"]
        rkeys = ["seg-new", "seg-1", "seg-6"]
        assert _ids(TTranslate, pair.troot, "k", None, keys) == \
            _ids(JTranslate, pair.jroot, "k", None, keys)
        assert _ids(TTranslate, pair.troot, "k", "f", rkeys) == \
            _ids(JTranslate, pair.jroot, "k", "f", rkeys)


def test_apply_schema_equal(pair):
    schema = pair.japi.schema()
    for api in (pair.japi, pair.tapi):
        api.delete_index("k")
        api.apply_schema(schema)
    assert pair.tapi.schema() == pair.japi.schema()


def test_delete_waits_for_build_images_and_compactions(index_dir, tmp_path,
                                                       monkeypatch):
    """A field deleted while its plane builds in the background (its
    ``.dense`` image write held) and while the compaction queue holds its
    fragments (one compaction held): the delete waits for both, then
    nothing of the field is cached, queued or on disk, and the field
    recreated and written answers what the reference answers."""
    root = _copy(index_dir, tmp_path / "t")
    holder = THolder(root).open()
    ex = TExecutor(holder, device="cpu", plane_paging=False)
    api = TAPI(holder, ex)
    ex.planes.SYNC_BUILD_MAX = 0   # every plane builds in the background
    fpath = os.path.join(root, "i", "f")
    writing, go_write = threading.Event(), threading.Event()
    write_sidecar = TFragment.write_sidecar_file

    def held_write(path, hdr, blob):
        writing.set()
        assert go_write.wait(30)
        write_sidecar(path, hdr, blob)

    monkeypatch.setattr(TFragment, "write_sidecar_file",
                        staticmethod(held_write))
    compacting, go_snap = threading.Event(), threading.Event()
    maybe_snapshot = TFragment.maybe_snapshot

    def held_snapshot(frag):
        if frag.path.startswith(fpath):
            compacting.set()
            assert go_snap.wait(30)
        maybe_snapshot(frag)

    monkeypatch.setattr(TFragment, "maybe_snapshot", held_snapshot)
    deleter = None
    try:
        # the first TopN starts the background build and answers another
        # way; the build's image writer blocks
        api.query("i", "TopN(f, n=3)")
        assert writing.wait(30)
        frags = list(holder.index("i").field("f").standard_view()
                     .fragments.values())
        for frag in frags:
            holder.snapshot_queue.submit(frag)
        assert compacting.wait(30)
        errors = []

        def delete():
            try:
                api.delete_field("i", "f")
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        deleter = threading.Thread(target=delete)
        deleter.start()
        time.sleep(0.3)
        assert deleter.is_alive()   # waiting on the held compaction
        go_snap.set()
        time.sleep(0.3)
        assert deleter.is_alive()   # waiting on the held image write
        go_write.set()
        deleter.join(30)
        assert not deleter.is_alive() and errors == []
    finally:
        go_snap.set()
        go_write.set()
        if deleter is not None:
            deleter.join(30)
    assert not os.path.exists(fpath)
    time.sleep(0.2)  # no late write lands
    assert not os.path.exists(fpath)
    assert holder.snapshot_queue.pending() == 0
    assert not ex.planes._building
    assert not [k for k in ex.planes._entries if k[1] == "i"]
    assert ex.planes.stats()["bytes"] == 0
    # recreated: nothing stale answers
    api.create_field("i", "f")
    api.import_bits("i", "f", row_ids=[1, 1, 2], col_ids=[3, SW + 3, 5])
    ex.planes.wait_builds()
    jroot = _copy(index_dir, tmp_path / "j")
    jh = JHolder(jroot).open()
    japi = JAPI(jh, JExecutor(jh, plane_paging=False))
    try:
        japi.delete_field("i", "f")
        japi.create_field("i", "f")
        japi.import_bits("i", "f", row_ids=[1, 1, 2], col_ids=[3, SW + 3, 5])
        for q in ("Count(Row(f=1))", "Count(Row(f=2))", "TopN(f, n=5)",
                  "Count(Intersect(Row(f=1), Row(m=2)))"):
            for _ in range(2):  # the background build, then the plane
                got = api.query("i", q)["results"]
                assert got == japi.query("i", q)["results"], q
                ex.planes.wait_builds()
    finally:
        japi.executor.translate.close()
        jh.close()
        ex.close()
        holder.close()


def test_queries_racing_a_delete(index_dir, tmp_path):
    """Client threads ask while the index is deleted and recreated: every
    answer is a count no larger than the exact one (a query that raced
    the delete reads what was left; the recreated index answers 0) or a
    "not found" error (the reference's 404, or its 400 while the
    recreated index lacks the field), never another failure."""
    import sys
    root = _copy(index_dir, tmp_path / "t")
    holder = THolder(root).open()
    ex = TExecutor(holder, device="cpu", plane_paging=False)
    api = TAPI(holder, ex)
    want = api.query("i", "Count(Row(f=1))")["results"]
    errors, seen = [], set()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                got = api.query("i", "Count(Row(f=1))")["results"]
                if not (len(got) == 1 and 0 <= got[0] <= want[0]):
                    errors.append(("answer", got))
                seen.add("answer")
            except ApiError as e:
                if e.status not in (400, 404) or "not found" not in str(e):
                    errors.append(("status", e.status, str(e)))
                seen.add(e.status)
            except Exception as e:  # noqa: BLE001 — the failure to find
                errors.append(("raised", repr(e)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ts = [threading.Thread(target=client) for _ in range(12)]
    try:
        for t in ts:
            t.start()
        for _ in range(3):
            time.sleep(0.05)
            api.delete_index("i")
            time.sleep(0.02)
            api.create_index("i")
            api.create_field("i", "f")
    finally:
        stop.set()
        for t in ts:
            t.join(30)
        sys.setswitchinterval(switch)
        ex.close()
        holder.close()
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert "answer" in seen


@pytest.mark.parametrize("view", ["standard", "custom", "standard_2021",
                                  "standard_x9"])
def test_import_roaring_any_view_equal(pair, view):
    pos = np.array([SW * 2 + 5, SW * 2 + 9, 7 * SW + 1], np.uint64)
    blob = jroaring.serialize(pos)
    path = f"/index/i/field/f/import-roaring/1?view={view}"
    status, _, body = _same(pair, "POST", path, blob)
    assert status == 200 and json.loads(body) == {"changed": 3}
    _same(pair, "POST", "/index/i/query", b"Count(Row(f=2))")
    pair.close()
    _assert_same_trees(pair.jroot, pair.troot)


def test_import_roaring_refuses_a_path_as_view(pair):
    with pytest.raises(ApiError, match="invalid view name"):
        pair.tapi.import_roaring("i", "f", 0, jroaring.serialize(
            np.array([1], np.uint64)), view="../x")
