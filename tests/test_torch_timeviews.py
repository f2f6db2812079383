"""Time-quantum fields in the port against the JAX package.

The same numpy inputs go through ``pilosa_tpu`` and ``pilosa_tpu_torch``
on the CPU, in both executor configurations ("off": each request alone,
no tree compiler; "default": the batcher, the tree compiler and the plan
cache):

- bytes on disk after timestamped ``import_bits``, ``set_bit``,
  ``clear_import`` and ``clear_bit`` (every view), and the fragments'
  journals;
- ``views_by_time_range`` and ``TimePlaneSet.bucket_range``;
- time-range ``Row`` / ``Range`` through the time plane and through the
  cover views' rows (an executor whose budget the plane exceeds);
- writes into existing buckets absorbed into the time plane's overlay
  (with a cell that clears a bit only one lane held), and a new bucket,
  a new row and a whole-row clear, each of which rebuilds;
- ``Rows`` / GroupBy with time filters; ``Shift``, ``Limit``,
  ``ConstRow`` and ``UnionRows`` and their errors; a plan-cache hit after
  a timestamped write; REST timestamps and ``/import-roaring`` into a
  time view.
"""

import json
import os
import shutil
import urllib.request
from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu import timeviews as jtv
from pilosa_tpu.api import API as JAPI
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu.store import timeq as jtimeq
from pilosa_tpu_torch import timeviews as ttv
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import FieldOptions as TFO
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import timeq as ttimeq
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
SHARDS = 3
T0 = datetime(2021, 1, 25)
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}
# the plane of the module index is 3 x 256 x 32768 int32 words (96 MiB):
# this budget keeps the other planes and sends time ranges to the span
# path
SPAN_BUDGET = 64 << 20


def ts(hours: int) -> str:
    return (T0 + timedelta(hours=hours)).strftime("%Y-%m-%dT%H:%M")


def _events(seed: int, n: int, rows: int = 4, hours: int = 24 * 40):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, n).astype(np.uint64)
    c = (rng.integers(0, SHARDS, n) * SW
         + rng.integers(0, 4000, n)).astype(np.uint64)
    stamps = [T0 + timedelta(hours=int(h))
              for h in rng.integers(0, hours, n)]
    return r, c, stamps


def _write(holder_cls, fo_cls, root: str, seed: int = 5, n: int = 600):
    """Index ``i``: a time field ``t`` (quantum YMD) with timestamped
    events over 40 days, and a set field ``f`` with the same pairs."""
    h = holder_cls(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("t", fo_cls(type="time", time_quantum="YMD"))
    rows, cols, stamps = _events(seed, n)
    idx.field("t").import_bits(rows, cols, stamps)
    idx.field("f").import_bits(rows, cols)
    idx.note_columns(cols)
    return h


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
            if f != ".meta":
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("timeviews") / "data")
    _write(JHolder, JFO, root).close()
    return root


@pytest.fixture(scope="module", params=list(CONFIGS))
def apis(index_dir, request):
    """(JAX API, port API, port API whose time ranges take the span path,
    configuration name) over the module index."""
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index_dir, mp, request.param)
    th, tapi = _port_api(index_dir, request.param)
    sh, sapi = _port_api(index_dir, request.param,
                         plane_budget=SPAN_BUDGET)
    yield japi, tapi, sapi, request.param
    for api in (tapi, sapi):
        api.executor.close()
    sh.close()
    th.close()
    jh.close()
    mp.undo()


# -- store ------------------------------------------------------------------


def test_store_bytes_and_journals_equal(tmp_path):
    """Timestamped imports, a timestamped set, a set field's timestamps
    (ignored), clears of every view: the same files byte for byte, and
    the same journal answers, in both packages."""
    roots = {}
    for name, hc, fo in (("j", JHolder, JFO), ("t", THolder, TFO)):
        root = str(tmp_path / name)
        h = _write(hc, fo, root, seed=9, n=300)
        idx = h.index("i")
        t = idx.field("t")
        gens = {v: t.views[v].fragments[1].generation
                for v in ("standard", "standard_202102")}
        rows, cols, stamps = _events(10, 200)
        t.import_bits(rows, cols, stamps)
        t.set_bit(2, SW + 7, datetime(2021, 2, 3, 4))
        idx.field("f").import_bits(rows[:20], cols[:20], stamps[:20])
        t.clear_import(rows[:50], cols[:50])
        t.clear_bit(2, SW + 7)
        roots[name] = (root, {v: t.views[v].fragments[1]
                              .changed_cells_since(g)
                              for v, g in gens.items()})
        h.close()
    jfiles, tfiles = _tree_files(roots["j"][0]), _tree_files(roots["t"][0])
    assert sorted(tfiles) == sorted(jfiles)
    assert any("standard_20210203" in k for k in tfiles)
    bad = [k for k in jfiles if jfiles[k] != tfiles[k]]
    assert not bad
    assert roots["t"][1] == roots["j"][1]
    # each package reopens what the other wrote
    jh = JHolder(roots["t"][0]).open()
    th = THolder(roots["j"][0]).open()
    try:
        assert sorted(th.index("i").field("t").views) == \
            sorted(jh.index("i").field("t").views)
    finally:
        th.close()
        jh.close()


def test_time_field_options_and_refusals(tmp_path):
    h = THolder(str(tmp_path)).open()
    idx = h.create_index("i")
    with pytest.raises(ValueError, match="invalid time quantum"):
        idx.create_field("bad", TFO(type="time", time_quantum="YD"))
    f = idx.create_field("t", TFO(type="time", time_quantum="ymd"))
    assert f.options.time_quantum == "YMD"
    with pytest.raises(ValueError, match="invalid field type"):
        idx.create_field("x", TFO(type="ranked"))
    # a mutex field takes no time views
    m = idx.create_field("m", TFO(type="mutex", time_quantum="YMD"))
    m.import_bits(np.array([1], np.uint64), np.array([5], np.uint64),
                  [datetime(2021, 2, 3)])
    assert sorted(m.views) == ["standard"]
    h.close()


# -- covers -----------------------------------------------------------------


@pytest.mark.parametrize("quantum", ["Y", "M", "D", "H", "YM", "MD", "DH",
                                     "YMD", "MDH", "YMDH"])
def test_views_by_time_range_equal(quantum):
    rng = np.random.default_rng(len(quantum))
    base = datetime(2019, 11, 28, 22)
    for _ in range(60):
        a = base + timedelta(hours=int(rng.integers(0, 24 * 500)))
        b = a + timedelta(hours=int(rng.integers(-48, 24 * 200)))
        assert ttimeq.views_by_time_range("standard", a, b, quantum) == \
            jtimeq.views_by_time_range("standard", a, b, quantum)
        assert ttimeq.views_by_time("standard", a, quantum) == \
            jtimeq.views_by_time("standard", a, quantum)
    for suf in ("2021", "202102", "20210203", "2021020304"):
        assert ttimeq.view_span(suf) == jtimeq.view_span(suf)
    for bad in ("20213", "abcd", ""):
        with pytest.raises(ValueError):
            ttimeq.parse_view_time(bad)


def test_bucket_range_equal(index_dir):
    """Quantum boundaries, omitted bounds and inverted ranges map to the
    same bucket range in both packages."""
    jh = JHolder(index_dir).open()
    th = THolder(index_dir).open()
    try:
        jf, tf = jh.index("i").field("t"), th.index("i").field("t")
        shards = tuple(range(SHARDS))
        assert ttv.bucket_suffixes(tf) == jtv.bucket_suffixes(jf)
        assert ttv.time_gens(tf, shards) == jtv.time_gens(jf, shards)
        tplan = ttv.plan_time_plane(tf, shards)
        jplan = jtv.plan_time_plane(jf, shards)
        assert tplan[:3] == jplan[:3] and tplan[4:] == jplan[4:]
        assert (tplan[3] == jplan[3]).all()
        geo = tplan[:3] + (tplan[3], tplan[4])
        tset = ttv.TimePlaneSet(None, shards, geo[3], geo[4], *geo[:3])
        jset = jtv.TimePlaneSet(None, shards, geo[3], geo[4], *geo[:3])
        edges = [None, T0, T0 - timedelta(days=3), T0 + timedelta(hours=5),
                 datetime(2021, 2, 1), datetime(2021, 2, 1, 0, 30),
                 datetime(2021, 3, 6), datetime(2022, 1, 1)]
        for a in edges:
            for b in edges:
                assert tset.bucket_range(a, b) == jset.bucket_range(a, b)
    finally:
        th.close()
        jh.close()


# -- time ranges ------------------------------------------------------------

RANGE_SHAPES = [
    f"Row(t=1, from={ts(0)}, to={ts(24)})",
    f"Row(t=1, from={ts(23)}, to={ts(25)})",
    f"Row(t=2, from={ts(24 * 7)}, to={ts(24 * 38)})",
    f"Row(t=0, from={ts(24 * 7)})",
    f"Row(t=3, to={ts(24 * 9)})",
    f"Row(t=1, from={ts(24 * 10)}, to={ts(24 * 10)})",
    f"Row(t=1, from={ts(24 * 12)}, to={ts(24 * 11)})",
    f"Row(t=9, from={ts(0)}, to={ts(24 * 30)})",
    f"Range(t=2, {ts(0)}, {ts(24 * 8)})",
    f"Row(t=1, from={ts(-24 * 30)}, to={ts(24 * 400)})",
    f"Count(Row(t=1, from={ts(24 * 7)}, to={ts(24 * 14)}))",
    (f"Count(Intersect(Row(t=1, from={ts(0)}, to={ts(24 * 7)}), "
     f"Row(t=1, from={ts(24 * 21)}, to={ts(24 * 28)})))"),
    f"Count(Intersect(Row(f=1), Row(t=2, from={ts(24 * 3)})))",
    f"Count(Union(Row(f=1), Not(Row(t=2, from={ts(24 * 3)}))))",
    f"TopN(t, Row(t=1, from={ts(24 * 7)}, to={ts(24 * 14)}), n=3)",
    f"TopN(f, Row(t=3, from={ts(24 * 2)}))",
    "Count(Row(t=1))",
    "TopN(t)",
    f"Row(f=1, from={ts(0)}, to={ts(5)})",
    "Row(t=1, from=2021-13-01T00:00)",
]


@pytest.mark.parametrize("pql", RANGE_SHAPES)
def test_time_ranges_equal(apis, pql):
    """Through the time plane and through the cover views' rows, the same
    answers as the JAX package."""
    japi, tapi, sapi, _ = apis
    want = _same(japi, tapi, pql)
    assert json.dumps(_answer(sapi, pql)) == json.dumps(want)


def test_random_ranges_plane_equals_span(apis):
    japi, tapi, sapi, _ = apis
    rng = np.random.default_rng(18)
    before = (tapi.executor.time_status()["rangesServed"],
              sapi.executor.time_status()["rangesServed"])
    for _ in range(12):
        row = int(rng.integers(0, 4))
        h0 = int(rng.integers(-48, 24 * 40))
        h1 = int(rng.integers(h0 - 24, 24 * 42))
        pql = f"Count(Row(t={row}, from={ts(h0)}, to={ts(h1)}))"
        want = _same(japi, tapi, pql)
        assert _answer(sapi, pql) == want
    after = (tapi.executor.time_status()["rangesServed"],
             sapi.executor.time_status()["rangesServed"])
    assert after[0]["plane"] - before[0]["plane"] == 12
    assert after[0]["span"] == before[0]["span"]
    assert after[1]["span"] - before[1]["span"] == 12
    assert after[1]["plane"] == before[1]["plane"]


ROWS_SHAPES = [
    f"Rows(t, from={ts(24 * 7)}, to={ts(24 * 14)})",
    f"Rows(t, from={ts(24 * 7)}, to={ts(24 * 8)}, column={SW + 17})",
    f"Rows(t, from={ts(0)}, previous=1, limit=2)",
    f"Rows(t, to={ts(0)})",
    f"Rows(f, from={ts(0)})",
    "Rows(t)",
    f"GroupBy(Rows(t, from={ts(24 * 7)}, to={ts(24 * 14)}))",
    f"GroupBy(Rows(f), Rows(t, from={ts(24 * 20)}))",
    (f"GroupBy(Rows(t, from={ts(24 * 3)}), filter=Row(t=1, "
     f"from={ts(24 * 5)}))"),
]


@pytest.mark.parametrize("pql", ROWS_SHAPES)
def test_rows_and_groupby_time_filters_equal(apis, pql):
    japi, tapi, _, _ = apis
    _same(japi, tapi, pql)


STATIC_SHAPES = [
    "Shift(Row(f=2), n=5)",
    "Count(Shift(Row(f=2), n=33))",
    f"Count(Shift(Row(t=1, from={ts(24 * 3)}), n=1))",
    "Count(Intersect(Row(f=1), Shift(Row(f=2), n=1)))",
    "Shift(Shift(Row(f=1), n=31), n=1)",
    "Limit(Row(f=0), limit=3, offset=1)",
    "Limit(Union(Row(f=0), Row(f=1)), offset=5)",
    "Count(Limit(Row(t=0), limit=8, offset=2))",
    "Count(Intersect(Row(f=1), Limit(Row(f=2), limit=5)))",
    "Limit(Row(f=1), limit=0)",
    "Limit(Row(f=1), offset=100000)",
    "ConstRow(columns=[1, 3, 3000000, 9000000])",
    "Count(Intersect(Row(t=0), ConstRow(columns=[0, 1, 2, 5, 1048580])))",
    "Count(Union(Row(f=3), ConstRow(columns=[7])))",
    "UnionRows(Rows(t))",
    "Count(UnionRows(Rows(f, limit=2), Rows(t, previous=1)))",
    "Count(Intersect(Row(f=1), UnionRows(Rows(t))))",
    "Count(UnionRows(Rows(t, column=5)))",
    # errors: the same texts in both packages
    "Shift(Row(f=1), n=-1)",
    "Shift(Row(f=1), Row(f=2))",
    "Count(Shift(Row(f=1), n=1048576))",
    "Limit(Row(f=1), limit=-1)",
    "Count(Limit(Row(f=1), Row(f=2), limit=1))",
    "ConstRow()",
    "UnionRows(Row(f=1))",
    "UnionRows()",
]


@pytest.mark.parametrize("pql", STATIC_SHAPES)
def test_static_ops_equal(apis, pql):
    """Shift, Limit, ConstRow and UnionRows: the tree compiler
    ("default") and the planned path ("off") against the JAX package,
    errors included."""
    japi, tapi, _, _ = apis
    _same(japi, tapi, pql)


# -- writes over a resident time plane --------------------------------------


@pytest.fixture(params=list(CONFIGS))
def fresh(tmp_path, monkeypatch, request):
    """A copy of a fresh small index opened by both packages."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _write(JHolder, JFO, jdir, seed=21, n=300).close()
    shutil.copytree(jdir, tdir)
    jh, japi = _jax_api(jdir, monkeypatch, request.param)
    th, tapi = _port_api(tdir, request.param)
    yield japi, tapi, request.param
    tapi.executor.close()
    th.close()
    jh.close()


def _both(japi, tapi, pql):
    want = japi.query("i", pql)["results"]
    assert tapi.query("i", pql)["results"] == want, pql
    return want


WINDOW = (f"Count(Row(t=1, from={ts(24 * 2)}, to={ts(24 * 9)}))"
          f"Row(t=1, from={ts(24 * 2)}, to={ts(24 * 9)})"
          f"Count(Intersect(Row(f=1), Row(t=1, from={ts(24 * 2)})))")


def _window_bits(tapi, row: int) -> dict:
    """column -> the window's day views holding it, for ``row`` of ``t``
    (the window of ``WINDOW``: 2021-01-27 .. 2021-02-02)."""
    tf = tapi.holder.index("i").field("t")
    days = [f"standard_202101{d}" for d in range(27, 32)] + \
        ["standard_20210201", "standard_20210202"]
    out: dict = {}
    for v in days:
        view = tf.view(v)
        for s, frag in (view.fragments.items() if view else ()):
            for c in np.flatnonzero(np.unpackbits(
                    frag.row_words(row).view(np.uint8), bitorder="little")):
                out.setdefault(s * SW + int(c), []).append(v)
    return out


def test_in_bucket_writes_absorb(fresh):
    """A write into existing buckets of existing rows is absorbed into the
    time plane's overlay, no build; a clear of a bit that only one lane of
    the range held drops it from the range's OR."""
    japi, tapi, _ = fresh
    planes = tapi.executor.planes
    _both(japi, tapi, WINDOW)
    builds = planes.builds
    held = _window_bits(tapi, 1)
    lone = min(c for c, vs in held.items() if len(vs) == 1)
    # a free column of a fragment that already holds row 1 on one day
    col = max(held) + 1
    day = held[max(held)][0][len("standard_"):]
    stamp = f"{day[:4]}-{day[4:6]}-{day[6:]}T05:00"
    absorbs = planes.delta_absorbs
    for pql in (f"Clear({lone}, t=1)", f"Set({col}, t=1, {stamp})"):
        _both(japi, tapi, pql)
        got = _both(japi, tapi, WINDOW)
    assert lone not in got[1]["columns"] and col in got[1]["columns"]
    assert planes.builds == builds
    assert planes.delta_absorbs == absorbs + 2
    status = tapi.executor.time_status()
    assert status["planes"][0]["delta"] is True
    assert status["rangesServed"]["span"] == 0


@pytest.mark.parametrize("write", [
    f"Set({SW + 5}, t=1, 2021-03-20T00:00)",       # a new bucket
    f"Set({SW + 5}, t=7, {ts(24 * 3)})",           # a new row
    "whole-row clear",
])
def test_rebuilds(fresh, write):
    japi, tapi, _ = fresh
    planes = tapi.executor.planes
    _both(japi, tapi, WINDOW)
    builds = planes.builds
    if write == "whole-row clear":
        # the journal entry a replayed op-log ClearRow leaves in a time
        # view (the ClearRow call clears the standard view only): both
        # packages clear row 1's words of one day's fragment, the port as
        # a whole-row op
        from pilosa_tpu_torch.store.oplog import OP_CLEAR_ROW
        frag = tapi.holder.index("i").field("t").view(
            "standard_20210128").fragment(0)
        cols = np.flatnonzero(np.unpackbits(frag.row_words(1).view(
            np.uint8), bitorder="little")).astype(np.uint64)
        with frag.lock:
            frag._apply(OP_CLEAR_ROW, 1, None)
        japi.holder.index("i").field("t").view(
            "standard_20210128").fragment(0).clear_bits(
                np.ones(len(cols), np.uint64), cols)
    else:
        _both(japi, tapi, write)
    _both(japi, tapi, WINDOW)
    _both(japi, tapi, f"Count(Row(t=7, from={ts(0)}))"
                      "Count(Row(t=1, from=2021-03-01T00:00))")
    assert planes.builds > builds


def test_plan_cache_hit_after_timestamped_write(fresh):
    """A time-range tree plan is generation-checked: a timestamped write
    drops it (the request that finds it stale takes the parse path and
    answers the write), the next request plans again, and the one after
    hits."""
    japi, tapi, config = fresh
    ex = tapi.executor
    pql = f"Count(Intersect(Row(f=1), Row(t=1, from={ts(24 * 2)})))"
    _both(japi, tapi, pql)
    hits, misses = ex.plan_hits, ex.plan_misses
    _both(japi, tapi, pql)
    if config == "off":
        return  # no tree compiler: nothing is planned
    assert (ex.plan_hits, ex.plan_misses) == (hits + 1, misses)
    held = _window_bits(tapi, 1)
    day = held[max(held)][0][len("standard_"):]
    _both(japi, tapi, f"Set({max(held) + 1}, t=1, "
                      f"{day[:4]}-{day[4:6]}-{day[6:]}T06:00)")
    misses += 1                      # the Set's own (unplannable) lookup
    _both(japi, tapi, pql)           # found stale: dropped, parse path
    assert (ex.plan_hits, ex.plan_misses) == (hits + 2, misses)
    _both(japi, tapi, pql)           # planned again
    assert ex.plan_misses == misses + 1
    _both(japi, tapi, pql)
    assert ex.plan_hits == hits + 3


def _post(base: str, path: str, body: bytes) -> dict:
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_rest_timestamps_and_time_views(tmp_path, monkeypatch):
    """REST ``/import`` with ISO strings and epoch seconds writes the same
    views and bits as the JAX package's API; ``/import-roaring`` writes a
    named time view; ``/status`` reports the time plane."""
    from pilosa_tpu.api import Server as JServer
    roots = {}
    stamps = ["2021-02-03T04:05", 1612324800, None, "2021-02-28", 0,
              "2021-03-01T00:00"]
    body = json.dumps({"rowIDs": [1, 1, 2, 2, 3, 1],
                       "columnIDs": [3, SW + 4, 5, 6, 7, 8],
                       "timestamps": stamps}).encode()
    blob = jroaring.serialize(np.array([2 * SW + 9, 3 * SW + 1], np.uint64))
    for name, hc, server_cls, api_of in (
            ("j", JHolder, JServer, lambda h: JAPI(h, JExecutor(
                h, plane_paging=False))),
            ("t", THolder, TServer, lambda h: TAPI(h, TExecutor(
                h, device="cpu")))):
        monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
        root = str(tmp_path / name)
        h = hc(root).open()
        api = api_of(h)
        srv = server_cls(api, "127.0.0.1", 0).start()
        try:
            base = "http://%s:%d" % srv.address
            _post(base, "/index/i", b"{}")
            _post(base, "/index/i/field/t", json.dumps({"options": {
                "type": "time", "timeQuantum": "YMD"}}).encode())
            assert _post(base, "/index/i/field/t/import", body) == \
                {"changed": 6}
            assert _post(base, "/index/i/field/t/import-roaring/0"
                               "?view=standard_20210210", blob) == \
                {"changed": 2}
            roots[name] = (root, _post(
                base, "/index/i/query",
                b"Row(t=1, from=2021-02-03T00:00, to=2021-02-04T00:00)"
                b"Row(t=2, from=2021-02-10T00:00, to=2021-02-11T00:00)"
                b"Rows(t, from=2021-02-28T00:00)"))
            if name == "t":
                with urllib.request.urlopen(base + "/status",
                                            timeout=60) as resp:
                    tv = json.loads(resp.read())["timeViews"]
                assert tv["planes"][0]["field"] == "t"
                assert tv["rangesServed"]["plane"] == 2
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(base, "/index/i/field/t/import-roaring/0"
                                "?view=../x", blob)
                assert e.value.code == 400
        finally:
            srv.close()
            if name == "t":
                api.executor.close()
            h.close()
    assert roots["t"][1] == {"results": roots["j"][1]["results"]}
    jfiles, tfiles = _tree_files(roots["j"][0]), _tree_files(roots["t"][0])
    assert sorted(tfiles) == sorted(jfiles)
    assert all(jfiles[k] == tfiles[k] for k in jfiles)
