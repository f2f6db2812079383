"""Keys and attributes in the port against the JAX package.

- ``KeyStore`` / ``TranslateStore`` against ``pilosa_tpu.store.translate``:
  the same ids for the same batches (repeats within a batch, create and
  no-create), ``keys_of`` strict and not, reopen with no replay, a failed
  commit's rollback, the legacy ``.keys`` migration, the replication
  calls, a store written by one package read by the other, and 16
  threads creating overlapping keys;
- ``AttrStore`` against ``pilosa_tpu.store.attrs``: merge, delete by
  ``None``, ``find_ids``, blocks and their merge, and stores read across
  packages;
- every keyed call through the JAX ``API`` (Pallas kernels in interpret
  mode) and the port's ``API`` on the CPU, in the "off" configuration and
  the default one, with JSON equal byte for byte: a keyed index ``k``
  (keyed set, time and mutex fields, an unkeyed set, bool and int field)
  and an unkeyed index ``u`` over three shards with a keyed field;
  unknown keys, the integer-on-keyed and string-on-unkeyed errors,
  ``like=``, keyed GroupBy / Extract / IncludesColumn / ConstRow, keyed
  time rows, and the attribute calls;
- writes (``Set``, ``Clear``, ``ClearRow``, ``Store``, ``SetRowAttrs``,
  ``SetColumnAttrs``) and keyed imports (``/import`` with keys and
  timestamps, ``importValue`` with column keys, ``/import-roaring`` into a
  keyed field) on a copy per package: the same answers, fragment and
  op-log bytes, key-store ids and attribute maps;
- the plan cache: a keyed entry planned while its key was missing plans
  again once a write creates the key.
"""

import json
import os
import shutil
import sqlite3
import struct
import zlib

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api.api import ApiError as JApiError
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import attrs as jattrs
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu.store import translate as jtr
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import ApiError, Server
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import attrs as tattrs
from pilosa_tpu_torch.store import translate as ttr
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}
N_COLS = 4000   # column keys of index k (one shard)
ROW_KEYS = ["a", "b", "ab", "abc", "b_x", "c%d", "zeta"]


# ---------------------------------------------------------------------------
# KeyStore and TranslateStore
# ---------------------------------------------------------------------------


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    pool = [f"user-{i:06d}" for i in range(5000)]
    for n in (1, 17, 400, 3500, 6001):
        yield [pool[i] for i in rng.integers(0, len(pool), n)]


@pytest.mark.parametrize("cache_size", [8, ttr.DEFAULT_CACHE_SIZE])
def test_keystore_same_ids(tmp_path, cache_size):
    """The same batches (repeats within a batch and across batches, more
    keys than ``_SQL_CHUNK``, an LRU smaller than a batch) give the same
    ids, create and no-create alike, and the same reverse lookups."""
    js = jtr.KeyStore(str(tmp_path / "j.sqlite"), cache_size=cache_size)
    ts = ttr.KeyStore(str(tmp_path / "t.sqlite"), cache_size=cache_size)
    try:
        for batch in _batches(3):
            assert ts.translate(batch) == js.translate(batch)
            got = ts.translate(batch, create=True)
            assert got == js.translate(batch, create=True)
            assert got[0] is not None and len(ts) == len(js)
            assert ts.translate(batch) == got
        ids = np.array([0, 1, 5, len(ts), len(ts) + 1, 3], np.uint64)
        assert ts.keys_of(ids, strict=False) == js.keys_of(ids, strict=False)
        assert ts.keys_of(ids[1:4]) == js.keys_of(ids[1:4])
        for bad in (ids, ids[4:]):
            with pytest.raises(KeyError) as te:
                ts.keys_of(bad)
            with pytest.raises(KeyError) as je:
                js.keys_of(bad)
            assert str(te.value) == str(je.value)
        for kid in (0, 1, 7, len(ts), len(ts) + 1):
            assert ts.key_of(kid) == js.key_of(kid)
        assert ts.tail(len(ts) - 5) == js.tail(len(js) - 5)
        assert ts.tail(3, limit=4) == js.tail(3, limit=4)
        assert ts.cache_info() == js.cache_info()
    finally:
        js.close()
        ts.close()


def test_keystore_reopen_cross_package_and_replication(tmp_path):
    """A store reopens with its high-water id and no replay; each package
    reads the other's store, and ``append_replicated`` applies overlaps
    once and refuses a gap with the reference's message."""
    path = str(tmp_path / "s.sqlite")
    ts = ttr.KeyStore(path)
    first = ts.translate(["x", "y", "x", "z"], create=True)
    ts.close()
    ts.close()  # closing twice is harmless
    js = jtr.KeyStore(path)
    assert js.translate(["z", "y", "x", "w"]) == [3, 2, 1, None]
    assert first == [1, 2, 1, 3]
    js.translate(["w"], create=True)
    js.close()
    ts = ttr.KeyStore(path)
    assert len(ts) == 4 and ts.keys_of([4, 1]) == ["w", "x"]
    ts.append_replicated(3, ["z", "w", "v", "u"])     # overlaps two
    assert ts.tail(4) == ["v", "u"]
    with pytest.raises(KeyError) as te:
        ts.append_replicated(9, ["q"])
    jgap = jtr.KeyStore(str(tmp_path / "g.sqlite"))
    with pytest.raises(KeyError) as je:
        jgap.append_replicated(2, ["q"])
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    jgap.close()
    ts.close()


def test_failed_commit_rolls_back(tmp_path):
    """A batch whose commit fails (a replicated key that already exists
    under another id) leaves the store and its high-water id as they
    were, in both packages."""
    out = []
    for mod, name in ((jtr, "j"), (ttr, "t")):
        s = mod.KeyStore(str(tmp_path / f"{name}.sqlite"))
        s.translate(["a", "b"], create=True)
        with pytest.raises(sqlite3.IntegrityError):
            s.append_replicated(3, ["c", "a"])
        out.append((len(s), s.tail(0), s.translate(["c", "d"], create=True)))
        s.close()
    assert out[0] == out[1] == (2, ["a", "b"], [3, 4])


def _legacy_log(path: str, keys) -> None:
    with open(path, "wb") as f:
        for k in keys:
            data = k.encode()
            rec = struct.pack("<I", len(data)) + data
            f.write(struct.pack("<I", zlib.crc32(rec)) + rec)
        f.write(b"\x01\x02\x03")   # a torn tail record


def test_legacy_migration_same(tmp_path):
    keys = [f"k{i}" for i in range(70000)]
    got = {}
    for mod, name in ((jtr, "j"), (ttr, "t")):
        d = tmp_path / name
        d.mkdir()
        _legacy_log(str(d / "f.keys"), keys)
        s = mod.KeyStore(str(d / "f.sqlite"))
        got[name] = (len(s), s.translate(["k0", "k69999", "k3", "nope"]),
                     sorted(os.listdir(d)))
        s.close()
    assert got["t"] == got["j"]
    assert got["t"][1][:3] == [1, 70000, 4]


def test_hash_partitions_equal():
    keys = ["", "a", "user-000000042", "seg-00007", "ключ"] + [
        f"k{i}" for i in range(200)]
    assert [ttr.fnv1a64(k.encode()) for k in keys] == \
        [jtr.fnv1a64(k.encode()) for k in keys]
    assert [ttr.partition_of(k) for k in keys] == \
        [jtr.partition_of(k) for k in keys]
    assert [ttr.partition_of(k, 7) for k in keys] == \
        [jtr.partition_of(k, 7) for k in keys]


def test_translate_store_layout(tmp_path):
    """Stores land in ``<index>/_keys/``; ``list_stores`` sees the open
    and the persisted ones; ``drop`` forgets an index's stores or removes
    a field's files; either package reads the other's layout."""
    root = str(tmp_path)
    ts = ttr.TranslateStore(root)
    assert ts.list_stores() == []
    assert ts.columns("i").translate(["c1", "c2"], create=True) == [1, 2]
    assert ts.rows("i", "f").translate(["r"], create=True) == [1]
    assert ts.rows("j", "g").translate(["s", "t"], create=True) == [1, 2]
    assert os.path.exists(os.path.join(root, "i", "_keys",
                                       "_columns.sqlite"))
    ts.close()
    js = jtr.TranslateStore(root)
    assert js.list_stores() == ts.list_stores() == [
        ("i", None), ("i", "f"), ("j", "g")]
    assert js.columns("i").translate(["c2", "c3"], create=True) == [2, 3]
    js.close()
    ts = ttr.TranslateStore(root)
    assert ts.columns("i").keys_of([3]) == ["c3"]
    ts.drop("j")
    ts.drop("i", "f", remove_files=True)
    assert not os.path.exists(os.path.join(root, "i", "_keys", "f.sqlite"))
    assert ts.rows("i", "f").translate(["r2"], create=True) == [1]
    ts.close()
    assert ttr.TranslateStore(str(tmp_path / "missing")).list_stores() == []


# ---------------------------------------------------------------------------
# AttrStore
# ---------------------------------------------------------------------------


def _attr_rows(path: str) -> list:
    with sqlite3.connect(path) as c:
        return c.execute("SELECT id, data FROM attrs ORDER BY id").fetchall()


def test_attrstore_same(tmp_path):
    writes = [(1, {"tier": "gold", "n": 5}), (2, {"tier": "gold"}),
              (1, {"n": None, "x": [1, 2]}), (3, {"tier": "silver"}),
              (250, {"a": True}), (2, {"tier": None}), (7, {"q": None}),
              (3, {"z": 1.5, "tier": "gold"})]
    out = []
    for mod, name in ((jattrs, "j"), (tattrs, "t")):
        s = mod.AttrStore(str(tmp_path / name / "_attrs.db"))
        res = [s.set_attrs(i, a) for i, a in writes]
        out.append((res, s.attrs(1), s.attrs(2), s.attrs_many([3, 9, 250]),
                    s.find_ids("tier", "gold"), s.find_ids("n", 5),
                    s.blocks(), s.block_items(0), s.block_items(2),
                    s.merge_items({1: {"x": 0, "new": 1}, 8: {"m": 2},
                                   250: {"a": True}}),
                    s.blocks()))
        s.close()
    assert json.dumps(out[0]) == json.dumps(out[1])
    assert _attr_rows(str(tmp_path / "j" / "_attrs.db")) == \
        _attr_rows(str(tmp_path / "t" / "_attrs.db"))
    # either package reads the other's store
    assert tattrs.AttrStore(str(tmp_path / "j" / "_attrs.db")).attrs(1) == \
        jattrs.AttrStore(str(tmp_path / "t" / "_attrs.db")).attrs(1)


# ---------------------------------------------------------------------------
# keyed calls through both packages
# ---------------------------------------------------------------------------


def _col_key(i: int) -> str:
    return f"c{i:05d}"


def _write(root: str) -> None:
    """Index ``k`` (keyed columns) and ``u`` (three shards, a keyed field)
    through ``pilosa_tpu``'s keyed import path."""
    from datetime import datetime
    rng = np.random.default_rng(21)
    h = JHolder(root).open()
    api = JAPI(h, JExecutor(h, plane_paging=False))
    try:
        api.create_index("k", {"keys": True})
        api.create_field("k", "f", {"keys": True})
        api.create_field("k", "t", {"type": "time", "timeQuantum": "YMD",
                                    "keys": True})
        api.create_field("k", "m", {"type": "mutex", "keys": True})
        api.create_field("k", "g")
        api.create_field("k", "b", {"type": "bool"})
        api.create_field("k", "v", {"type": "int", "min": -500,
                                    "max": 500})
        n = 9000
        cols = [_col_key(i) for i in rng.integers(0, N_COLS, n)]
        api.import_bits("k", "f", col_keys=cols, row_keys=[
            ROW_KEYS[i] for i in rng.integers(0, len(ROW_KEYS), n)])
        api.import_bits("k", "g", col_keys=cols[:4000],
                        row_ids=rng.integers(0, 3, 4000).tolist())
        api.import_bits("k", "m", col_keys=cols[:3000], row_keys=[
            ROW_KEYS[i] for i in rng.integers(0, 4, 3000)])
        api.import_bits("k", "b", col_keys=cols[1000:3000],
                        row_ids=rng.integers(0, 2, 2000).tolist())
        api.import_bits("k", "t", col_keys=cols[:600], row_keys=[
            ROW_KEYS[i] for i in rng.integers(0, 3, 600)],
            timestamps=[datetime(2021, 2, 1 + i % 20).isoformat()
                        for i in range(600)])
        api.import_values("k", "v", col_keys=cols[:1500],
                          values=rng.integers(-500, 501, 1500).tolist())
        api.create_index("u")
        api.create_field("u", "kf", {"keys": True})
        api.create_field("u", "g")
        ucols = (rng.integers(0, 3, 6000) * SW
                 + rng.integers(0, 5000, 6000)).tolist()
        api.import_bits("u", "kf", col_ids=ucols, row_keys=[
            ROW_KEYS[i] for i in rng.integers(0, 4, 6000)])
        api.import_bits("u", "g", col_ids=ucols,
                        row_ids=rng.integers(0, 3, 6000).tolist())
    finally:
        api.executor.translate.close()
        h.close()


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


def _answer(api, index: str, pql: str):
    try:
        return api.query(index, pql)["results"]
    except Exception as e:  # noqa: BLE001 — compared between packages
        return ("error", type(e).__name__, str(e))


def _same(japi, tapi, index: str, pql: str):
    want = _answer(japi, index, pql)
    got = _answer(tapi, index, pql)
    assert json.dumps(got) == json.dumps(want), (index, pql)
    return got


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("keys") / "data")
    _write(root)
    return root


@pytest.fixture(scope="module", params=list(CONFIGS))
def apis(data, request):
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(data, mp, request.param)
    th, tapi = _port_api(data, request.param)
    yield japi, tapi
    tapi.executor.close()
    japi.executor.translate.close()
    th.close()
    jh.close()
    mp.undo()


TS = "from=2021-02-03T00:00, to=2021-02-11T00:00"
K_READS = [
    'Row(f="a")',
    'Row(f="nope")',
    'Row(f=1)',
    'Row(g="x")',
    'Row(g=1)',
    'Count(Row(f="a"))',
    'Count(Row(f="a"))Count(Row(f="b"))Count(Row(f="nope"))'
    'Count(Row(f="zeta"))',
    "".join(f'Count(Row(f="{k}"))' for k in ROW_KEYS),
    'Count(Intersect(Row(f="a"), Row(g=1)))',
    'Count(Union(Row(f="a"), Row(f="nope")))',
    'Count(Intersect(Row(g=1), Row(f="nope")))',
    'Count(Difference(Row(f="b"), Row(m="a")))Count(Xor(Row(f="ab"), '
    'Row(b=true)))',
    'Count(Not(Row(f="a")))',
    'Not(Row(f="a"))',
    "All()",
    "All(limit=5, offset=2)",
    "TopN(f)",
    "TopN(f, n=3)",
    "TopN(f, Row(g=0), n=3)",
    'TopN(f, Row(m="b"))',
    "TopN(m)",
    "TopN(g, n=2)",
    "TopN(f, attrName=tier, attrValue=gold)",
    "Rows(f)",
    'Rows(f, like="a%")',
    'Rows(f, like="_")',
    'Rows(f, like="b\\_%")',
    'Rows(f, like="%")',
    'Rows(f, like="nomatch%")',
    'Rows(f, previous="ab")',
    'Rows(f, previous="nope")',
    'Rows(f, previous="ab", limit=2)',
    'Rows(f, column="%s")' % _col_key(5),
    'Rows(f, column="nope")',
    'Rows(f, column=5)',
    'Rows(g, like="a%")',
    "Rows(m)",
    "Rows(t)",
    'Rows(t, from=2021-02-05T00:00, to=2021-02-09T00:00)',
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f, limit=2), Rows(m))",
    'GroupBy(Rows(m), Rows(f, like="a%"), filter=Row(g=1))',
    "GroupBy(Rows(m), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(f), limit=4)",
    "GroupBy(Rows(f), Rows(b), having=Condition(count > 30))",
    "GroupBy(Rows(t), Rows(g))",
    'Extract(Limit(Row(f="a"), limit=20), Rows(f), Rows(m), Rows(b), '
    'Rows(v), Rows(t), Rows(g))',
    'Extract(Row(f="nope"), Rows(f))',
    'Extract(ConstRow(columns=["%s", "%s", "nope"]), Rows(f), Rows(m))'
    % (_col_key(3), _col_key(9)),
    'IncludesColumn(Row(f="a"), column="%s")' % _col_key(7),
    'IncludesColumn(Row(f="a"), column="nope")',
    'IncludesColumn(Row(f="a"), column=7)',
    'ConstRow(columns=["%s", "nope", "%s"])' % (_col_key(1), _col_key(2)),
    'ConstRow(columns=[1])',
    'Count(Intersect(Row(f="a"), ConstRow(columns=["%s", "%s"])))'
    % (_col_key(1), _col_key(2)),
    'Row(t="a", %s)' % TS,
    'Count(Row(t="b", %s))' % TS,
    'Row(t="nope", %s)' % TS,
    'Row(f="nope", %s)' % TS,
    'Count(Intersect(Row(t="a", %s), Row(f="b")))' % TS,
    'Range(t="a", 2021-02-03T00:00, 2021-02-06T00:00)',
    'Options(Row(f="a"), excludeColumns=true)',
    'Options(Row(f="a"), columnAttrs=true)',
    'Options(Row(f="a"), columnAttrs=true, excludeColumns=true)',
    'Options(Count(Row(f="a")), columnAttrs=true)',
    'Sum(Row(f="a"), field=v)',
    'Min(Row(f="nope"), field=v)',
    'UnionRows(Rows(f, like="a%"))',
    "Count(UnionRows(Rows(f), Rows(m)))",
    'Limit(Row(f="a"), limit=3, offset=1)',
    'Count(Limit(Row(f="b"), limit=7))',
    'Shift(Row(f="a"), n=1)',
    'Count(Shift(Row(f="a"), n=1))',
    'Row(f="a", excludeRowAttrs=true)',
    'Count(Row(m="a"))Count(Row(m="b"))',
]
U_READS = [
    'Row(kf="a")',
    'Row(kf="nope")',
    'Row(kf=1)',
    'Row(g="x")',
    "TopN(kf)",
    "TopN(kf, Row(g=1), n=2)",
    "Rows(kf)",
    'Rows(kf, like="a%")',
    "Rows(kf, column=%d)" % (SW + 7),
    "GroupBy(Rows(kf), Rows(g))",
    "GroupBy(Rows(g), Rows(kf, previous=\"a\"))",
    "Extract(Limit(Row(g=1), limit=12), Rows(kf), Rows(g))",
    'Count(Row(kf="a"))Count(Row(kf="b"))Count(Row(kf="x"))',
    'Count(Intersect(Row(g=1), Row(kf="ab")))',
    'Count(Union(Row(kf="a"), Row(g=2)))',
    'IncludesColumn(Row(kf="a"), column="x")',
    "IncludesColumn(Row(kf=\"a\"), column=%d)" % (2 * SW + 9),
    'ConstRow(columns=["x"])',
    "Options(Row(g=1), columnAttrs=true)",
]


@pytest.mark.parametrize("pql", K_READS)
def test_keyed_index_reads_equal(apis, pql):
    japi, tapi = apis
    _same(japi, tapi, "k", pql)


@pytest.mark.parametrize("pql", U_READS)
def test_keyed_field_reads_equal(apis, pql):
    japi, tapi = apis
    _same(japi, tapi, "u", pql)


def test_tanimoto_stays_refused(apis):
    """``tanimoto=`` and ``_rowCounts=`` on a keyed index were refused until
    the port served them; they now answer the reference's JSON."""
    japi, tapi = apis
    for pql in ('TopN(f, Row(g=1), n=2, tanimoto=50)',
                'TopN(f, Row(g=1), _rowCounts=1)',
                'TopN(f, Row(g=1), tanimoto=1)'):
        got = _same(japi, tapi, "k", pql)
        assert got[0] != "error", pql


def test_reads_create_no_key(apis, data):
    """A read of unknown keys creates nothing: every key store keeps its
    ids after the reads."""
    japi, tapi = apis
    before = _key_rows(data)
    for pql in ('Count(Row(f="fresh"))', 'Row(f="fresh2")',
                'IncludesColumn(Row(f="a"), column="fresh3")',
                'Rows(f, column="fresh4")', 'Rows(f, previous="fresh5")',
                'ConstRow(columns=["fresh6"])', 'Clear("fresh7", f="a")',
                'ClearRow(f="fresh8")', 'Clear("%s", f="fresh9")'
                % _col_key(1)):
        _same(japi, tapi, "k", pql)
    assert _key_rows(data) == before


# ---------------------------------------------------------------------------
# writes and imports on a copy per package
# ---------------------------------------------------------------------------


def _key_rows(root: str) -> dict:
    """Every key store's (id, key) rows and every attribute store's (id,
    JSON) rows under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".sqlite"):
                with sqlite3.connect(p) as c:
                    out[rel] = c.execute(
                        "SELECT id, key FROM keys ORDER BY id").fetchall()
            elif f == "_attrs.db":
                out[rel] = _attr_rows(p)
    return out


def _data_files(root: str) -> dict:
    """Fragment snapshots and op-logs, and the meta files, by path."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if ".sqlite" in f or "_attrs.db" in f:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(params=list(CONFIGS))
def pair(data, tmp_path, request):
    """A copy of the data for each package, and both APIs over them."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(data, jroot)
    shutil.copytree(data, troot)
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(jroot, mp, request.param)
    th, tapi = _port_api(troot, request.param)
    state = {"open": True}

    def close():
        if state["open"]:
            state["open"] = False
            tapi.executor.close()
            japi.executor.translate.close()
            th.close()
            jh.close()

    yield japi, tapi, jroot, troot, close
    close()
    mp.undo()


WRITES = [
    ("k", 'Set("%s", f="new")' % _col_key(N_COLS + 5)),
    ("k", 'Count(Row(f="new"))'),
    ("k", 'Row(f="new")'),
    ("k", 'Set("%s", f="new")' % _col_key(N_COLS + 5)),
    ("k", 'Set("brand-new", f="a")'),
    ("k", 'Count(Row(f="a"))'),
    ("k", 'Clear("%s", f="new")' % _col_key(N_COLS + 5)),
    ("k", 'Clear("nope", f="a")'),
    ("k", 'Clear("%s", f="nope")' % _col_key(1)),
    ("k", 'ClearRow(f="nope")'),
    ("k", 'ClearRow(f="zeta")'),
    ("k", 'Rows(f)'),
    ("k", 'Store(Intersect(Row(f="a"), Row(g=1)), f="stored")'),
    ("k", 'Count(Row(f="stored"))'),
    ("k", 'Set(5, f="a")'),
    ("k", 'Set("int-row", f=1)'),
    ("k", 'Set("str-row", g="x")'),
    ("k", 'Set("%s", t="c", 2021-02-04T05:00)' % _col_key(2)),
    ("k", 'Count(Row(t="c", from=2021-02-04T00:00, to=2021-02-05T00:00))'),
    ("k", 'Set("%s", m="zeta")' % _col_key(2)),
    ("k", 'Extract(ConstRow(columns=["%s"]), Rows(m), Rows(t), Rows(f))'
     % _col_key(2)),
    ("k", 'Set("%s", v=-17)' % _col_key(2)),
    ("k", 'Sum(field=v)'),
    ("k", 'SetRowAttrs(f, "a", tier="gold", n=5)'),
    ("k", 'SetRowAttrs(f, "b", tier="gold")'),
    ("k", 'SetRowAttrs(f, "fresh", tier="silver")'),
    ("k", 'Row(f="a")'),
    ("k", 'Row(f="a", excludeRowAttrs=true)'),
    ("k", 'Options(Row(f="b"), excludeColumns=true)'),
    ("k", 'SetRowAttrs(f, "a", n=null)'),
    ("k", 'Row(f="a")'),
    ("k", 'TopN(f, n=5, attrName="tier", attrValue="gold")'),
    ("k", 'TopN(f, attrName="tier", attrValue="none")'),
    ("k", 'TopN(f, Row(g=1), attrName="tier", attrValue="gold")'),
    ("k", 'SetRowAttrs(f, 3, x=1)'),
    ("k", 'SetRowAttrs(g, 1, x=1)'),
    ("k", 'Row(g=1)'),
    ("k", 'SetColumnAttrs("%s", vip=true)' % _col_key(1)),
    ("k", 'SetColumnAttrs("col-attr-new", vip=false)'),
    ("k", 'SetColumnAttrs(3, vip=true)'),
    ("k", 'Options(Row(f="a"), columnAttrs=true)'),
    ("k", 'Rows(f)'),
    ("u", 'SetColumnAttrs(%d, vip=true, score=7)' % (SW + 7)),
    ("u", 'SetColumnAttrs(5, vip=true)'),
    ("u", 'SetColumnAttrs("x", vip=true)'),
    ("u", 'Options(Row(kf="a"), columnAttrs=true)'),
    ("u", 'Options(Row(kf="a"), columnAttrs=true, excludeColumns=true)'),
    ("u", 'Set(%d, kf="new")' % (2 * SW + 3)),
    ("u", 'SetRowAttrs(kf, "new", tier="gold")'),
    ("u", 'Row(kf="new")'),
    ("u", 'TopN(kf, attrName="tier", attrValue="gold")'),
    ("u", 'Set(%d, kf=4)' % (2 * SW + 3)),
    ("u", 'ClearRow(kf="new")'),
    ("u", 'Rows(kf)'),
]


def test_writes_equal(pair):
    """Keyed writes and attribute calls: the same answers step by step,
    then the same fragment and op-log bytes, key-store ids and attribute
    maps."""
    japi, tapi, jroot, troot, close = pair
    for index, pql in WRITES:
        _same(japi, tapi, index, pql)
    close()
    assert _key_rows(troot) == _key_rows(jroot)
    assert _data_files(troot) == _data_files(jroot)


def _both(japi, tapi, fn, *a, **kw):
    """``fn`` on each API: the same result or the same error (text and
    status)."""
    out = []
    for api in (japi, tapi):
        try:
            out.append(getattr(api, fn)(*a, **kw))
        except (JApiError, ApiError) as e:
            out.append(("error", str(e), e.status))
    assert out[0] == out[1], (fn, out)
    return out[1]


def test_keyed_imports_equal(pair):
    """Keyed ``/import`` (with timestamps and clears), ``importValue`` with
    column keys and ``/import-roaring`` into a keyed field and index take
    the reference's ids and answer its errors; the files and key stores
    match after."""
    from datetime import datetime
    japi, tapi, jroot, troot, close = pair
    rng = np.random.default_rng(5)
    cols = [_col_key(i) for i in rng.integers(0, N_COLS + 300, 3000)]
    rows = [ROW_KEYS[i] for i in rng.integers(0, len(ROW_KEYS), 3000)]
    rows[7] = rows[9] = "imported"
    assert _both(japi, tapi, "import_bits", "k", "f", row_keys=rows,
                 col_keys=cols) > 0
    _both(japi, tapi, "import_bits", "k", "f", row_keys=rows[:500],
          col_keys=cols[:500], clear=True)
    _both(japi, tapi, "import_bits", "k", "t", row_keys=rows[:400],
          col_keys=cols[:400],
          timestamps=[datetime(2021, 3, 1 + i % 9).isoformat()
                      for i in range(400)])
    _both(japi, tapi, "import_bits", "k", "m", row_keys=rows[:900],
          col_keys=cols[:900])
    _both(japi, tapi, "import_values", "k", "v", col_keys=cols[:700],
          values=rng.integers(-500, 501, 700).tolist())
    _both(japi, tapi, "import_bits", "u", "kf", row_keys=rows[:300],
          col_ids=(rng.integers(0, 3, 300) * SW
                   + rng.integers(0, 9000, 300)).tolist())
    # the reference's errors, including a mismatch after the keys exist
    for index, field, kw in (
            ("k", "f", {"row_keys": ["e1"], "col_ids": [1]}),
            ("k", "f", {"row_ids": [1], "col_keys": ["e2"]}),
            ("k", "g", {"row_keys": ["e3"], "col_keys": ["e4"]}),
            ("k", "f", {"row_keys": ["e5", "e6"], "col_keys": ["e7"]}),
            ("k", "f", {"col_keys": ["e8"]}),
            ("k", "f", {"row_keys": ["e9"]}),
            ("u", "g", {"row_ids": [1], "col_keys": ["e10"]}),
            ("u", "kf", {"row_ids": [1], "col_ids": [1]})):
        _both(japi, tapi, "import_bits", index, field, **kw)
    for kw in ({"col_ids": [1], "values": [3]},
               {"col_keys": ["e11", "e12"], "values": [3]},
               {"values": [3]}):
        _both(japi, tapi, "import_values", "k", "v", **kw)
    _both(japi, tapi, "import_values", "u", "v", col_keys=["x"],
          values=[1])
    # import-roaring takes raw ids on a keyed field and index
    blob = jroaring.serialize(np.array([2 * SW + 3, 9 * SW + 4000],
                                       np.uint64))
    _both(japi, tapi, "import_roaring", "k", "f", 0, blob)
    _both(japi, tapi, "import_roaring", "u", "kf", 1, blob)
    for index, pql in (
            ("k", "".join(f'Count(Row(f="{k}"))'
                          for k in ROW_KEYS + ["imported"])),
            ("k", "TopN(f)"), ("k", "Rows(f)"),
            ("k", 'Row(f="imported")'),
            ("k", 'Count(Row(t="a", from=2021-03-01T00:00))'),
            ("k", "GroupBy(Rows(m), aggregate=Sum(field=v))"),
            ("k", 'Count(Row(f="c%d"))'), ("k", 'Row(f="c%d")'),
            ("u", "TopN(kf)"), ("u", 'Count(Row(kf="a"))')):
        _same(japi, tapi, index, pql)
    close()
    assert _key_rows(troot) == _key_rows(jroot)
    assert _data_files(troot) == _data_files(jroot)


def test_rest_keyed_import(tmp_path):
    """Keyed bodies over the port's REST routes: ``rowKeys`` /
    ``columnKeys`` import and ``importValue``, a keyed query back, and the
    reference's 400 for keys on an unkeyed field."""
    import urllib.error
    import urllib.request
    holder = THolder(str(tmp_path)).open()
    api = TAPI(holder, TExecutor(holder, device="cpu"))
    server = Server(api, "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    try:
        post("/index/k", json.dumps({"options": {"keys": True}}).encode())
        post("/index/k/field/f",
             json.dumps({"options": {"keys": True}}).encode())
        post("/index/k/field/v", json.dumps({"options": {
            "type": "int", "min": 0, "max": 100}}).encode())
        post("/index/k/field/g", b"{}")
        assert post("/index/k/field/f/import", json.dumps({
            "rowKeys": ["x", "y", "x"], "columnKeys": ["u1", "u2", "u3"]
        }).encode()) == (200, {"changed": 3})
        assert post("/index/k/field/v/importValue", json.dumps({
            "columnKeys": ["u2", "u4"], "values": [7, 9]}).encode()) == \
            (200, {"changed": 7})   # exists + 3 bits, exists + 2 bits
        assert post("/index/k/query", b'Row(f="x")Sum(field=v)TopN(f)') == \
            (200, {"results": [{"keys": ["u1", "u3"]},
                               {"value": 16, "count": 2},
                               [{"key": "x", "count": 2},
                                {"key": "y", "count": 1}]]})
        status, body = post("/index/k/field/g/import", json.dumps({
            "rowKeys": ["x"], "columnKeys": ["u1"]}).encode())
        assert (status, body) == (400, {"error": "field 'g' is not keyed"})
    finally:
        server.close()
        api.close()
        holder.close()


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
def test_plan_replans_after_key_appears(data, tmp_path, config):
    """A cached plan that saw a key as missing answers 0, and plans again
    once a write creates the key: a plain-row Count batch (the plane
    entry), a tree with the key in the anchor field, one with the key in
    another field than the anchor, and the generic entry.  The JAX
    package answers the same where its plan covers the case."""
    mp = pytest.MonkeyPatch()
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(data, jroot)
    shutil.copytree(data, troot)
    jh, japi = _jax_api(jroot, mp, config)
    th, tapi = _port_api(troot, config)
    col = _col_key(11)
    try:
        # g row 1 holds col (written below through both packages)
        _same(japi, tapi, "k", 'Set("%s", g=1)' % col)
        queries = ['Count(Row(f="later"))Count(Row(f="a"))',
                   'Count(Intersect(Row(f="later"), Row(f="later")))',
                   'Count(Union(Row(f="later"), Row(m="a")))',
                   'Count(Intersect(Row(g=1), Row(f="later")))']
        want0 = [_same(japi, tapi, "k", q) for q in queries]
        for q in queries:   # planned and cached: hits now
            _same(japi, tapi, "k", q)
        hits = tapi.executor.plan_hits
        for q in queries:
            _same(japi, tapi, "k", q)
        assert tapi.executor.plan_hits == hits + len(queries)
        _same(japi, tapi, "k", 'Set("%s", f="later")' % col)
        got = [_answer(tapi, "k", q) for q in queries]
        assert got[0] == [1, want0[0][1]]
        assert got[1] == [1]
        assert got[2] == [want0[2][0] + (0 if col in _answer(
            tapi, "k", 'Row(m="a")')[0]["keys"] else 1)]
        assert got[3] == [1]
        # the reference plans the last two as trees anchored on another
        # field than the missing key's and keeps serving the stale 0
        for q in queries[:2]:
            _same(japi, tapi, "k", q)
    finally:
        tapi.executor.close()
        japi.executor.translate.close()
        th.close()
        jh.close()
        mp.undo()


def test_keystore_concurrent_creates(tmp_path):
    """16 threads translate overlapping batches with ``create`` under a
    short switch interval: every key gets one id, the ids are 1..n with
    no gap, and every thread saw the id the store keeps."""
    import sys
    import threading
    s = ttr.KeyStore(str(tmp_path / "c.sqlite"), cache_size=64)
    pool = [f"k{i}" for i in range(3000)]
    seen: list = []
    errors: list = []
    lock = threading.Lock()

    def work(seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            for _ in range(20):
                batch = [pool[i] for i in rng.integers(0, len(pool), 150)]
                ids = s.translate(batch, create=True)
                with lock:
                    seen.extend(zip(batch, ids))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    kept = dict(zip(s.tail(0), range(1, len(s) + 1)))
    assert sorted(kept.values()) == list(range(1, len(s) + 1))
    assert all(kept[k] == kid for k, kid in seen)
    assert set(kept) == {k for k, _ in seen}
    s.close()
