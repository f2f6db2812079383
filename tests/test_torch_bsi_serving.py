"""BSI fields through the port's store, executor and API, against the JAX
package on the same on-disk holder.

One data directory (set fields ``f`` and ``g``, an int field ``amount``
of depth 13 and a decimal field ``price``, over 3 shards, written by the
JAX package) answers the BSI request list through the JAX ``API`` and
the port's, in both executor configurations ("off" and "default"); the
JSON must be equal.  Also here: the bytes both packages' value imports
write, the ``FieldOptions`` derivation, value imports over REST absorbed
into a resident bit plane's overlay (no rebuild), folds, depth growth,
the overlay's pad lanes, co-batching of concurrent BSI items and a
failing BSI launch."""

import json
import os
import shutil
import threading
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import tree as jtree
from pilosa_tpu.exec.executor import _Ctx as JCtx
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store.field import FieldOptions as JFieldOptions
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.engine import bsi as tbsi
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import tree as ttree
from pilosa_tpu_torch.exec.executor import _Ctx as TCtx
from pilosa_tpu_torch.exec.fused import FusedCache
from pilosa_tpu_torch.ingest.delta import DeltaMirror, bsi_sides
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store.field import FieldOptions as TFieldOptions
from test_torch_batcher import _run_threads

SHARDS, SW = 3, 1 << 20
AMOUNT = {"type": "int", "min": -5000, "max": 5000, "created_at": 1.0}
PRICE = {"type": "decimal", "min": -100, "max": 100, "scale": 2,
         "created_at": 1.0}
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}

READS = [
    "Sum(field=amount)", "Sum(Row(g=0), field=amount)",
    "Sum(Row(f=99), field=amount)", "Min(field=amount)",
    "Max(field=amount)", "Min(Row(g=1), field=amount)",
    "Max(Row(g=1), field=amount)",
    "Count(Row(amount > 2500))", "Count(Row(amount < -2500))",
    "Count(Row(amount >= 0))", "Count(Row(amount <= -1))",
    "Count(Row(amount == 17))", "Count(Row(amount != 17))",
    "Count(Row(amount=-17))",
    "Count(Row(-100 < amount < 100))", "Count(Row(-100 <= amount < 100))",
    "Count(Row(-100 < amount <= 100))", "Count(Row(-100 <= amount <= 100))",
    "Count(Row(amount > 99999))", "Count(Row(amount < 99999))",
    "Count(Row(amount != 99999))", "Count(Row(amount > -99999))",
    "Count(Row(amount < -99999))", "Count(Row(-99999 < amount < 99999))",
    ("Count(Row(amount > 2500))Count(Row(-100 < amount < 100))"
     "Count(Row(amount > 2500))"),
    "Count(Row(amount > 2500))Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(amount >= 0)))",
    "Count(Union(Row(f=2), Row(amount > 4000)))",
    "Count(Intersect(Row(f=1), Row(amount > 99999)))",
    "Count(Intersect(Row(f=1), Row(amount < -99999)))",
    "Count(Difference(Row(f=3), Row(-50 < amount < 50)))",
    "Count(Not(Row(amount > 0)))",
    "Count(Intersect(Row(amount > 0), Row(amount < 1000)))",
    "Row(amount > 4990)", "Row(-3 <= amount <= 3)",
    "TopN(f, Row(amount > 2000), n=5)", "TopN(f, Row(-1000 < amount < 1000))",
    "Percentile(field=amount, nth=0)", "Percentile(field=amount, nth=50)",
    "Percentile(field=amount, nth=99.9)",
    "Percentile(field=amount, nth=100)",
    "Percentile(Row(g=0), field=amount, nth=90)",
    "Distinct(Row(amount > 4900), field=amount)",
    "Distinct(Row(g=1), field=amount)",
    "Sum(field=price)", "Min(field=price)", "Max(field=price)",
    "Count(Row(price > 10.5))", "Count(Row(-2.5 < price < 2.5))",
]
# the chip_smoke.py phase-5 request list, at this index's scale
CHIP_MIX = READS[0:1] + READS[1:2] + READS[3:4] + READS[6:7] + [
    "Count(Row(amount > 2500))", "Count(Row(-100 < amount < 100))",
    "Count(Intersect(Row(f=1), Row(amount >= 0)))",
    "TopN(f, Row(amount > 2000), n=5)", "Percentile(field=amount, nth=99)",
    "Distinct(Row(amount > 4990), field=amount)"]
WRITES = [
    "Set(5, amount=77)", "Sum(field=amount)", "Count(Row(amount == 77))",
    "Set(5, amount=-78)", "Count(Row(amount == 77))",
    "Count(Row(amount == -78))", "Min(field=amount)",
    f"Set({SW + 9}, amount=5000)", "Max(field=amount)",
    "Clear(5, amount=0)", "Clear(5, amount=0)", "Count(Row(amount == -78))",
    "Sum(field=amount)", "Set(9, price=-1.25)", "Sum(field=price)",
]


def _write_index(root: str) -> None:
    rng = np.random.default_rng(11)
    h = JHolder(root).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
    idx.create_field("amount", JFieldOptions(**AMOUNT))
    idx.create_field("price", JFieldOptions(**PRICE))
    for name, rows, n in (("f", 8, 30000), ("g", 2, 40000)):
        cols = rng.choice(SHARDS * SW, n, replace=False).astype(np.uint64)
        idx.field(name).import_bits(
            rng.integers(0, rows, n).astype(np.uint64), cols)
        idx.note_columns(cols)
    cols = rng.choice(SHARDS * SW, 20000, replace=False).astype(np.uint64)
    vals = rng.integers(-5000, 5001, len(cols))
    vals[:40] = 17
    vals[40:80] = -17
    idx.field("amount").import_values(cols, vals.tolist())
    idx.note_columns(cols)
    cols = rng.choice(SHARDS * SW, 3000, replace=False).astype(np.uint64)
    idx.field("price").import_values(
        cols, np.round(rng.uniform(-100, 100, len(cols)), 2).tolist())
    h.close()


def _jax_api(root: str, monkeypatch, config: str):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    ex = JExecutor(holder, plane_paging=False, kernel_tier="pallas",
                   **CONFIGS[config])
    return holder, JAPI(holder, ex)


def _port_api(root: str, config: str, **kw):
    holder = THolder(root).open()
    return holder, TAPI(holder, TExecutor(holder, device="cpu",
                                          **CONFIGS[config], **kw))


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bsi") / "data")
    _write_index(root)
    return root


@pytest.fixture(scope="module")
def jax_answers(index_dir):
    """Every READS answer from the JAX package ("off")."""
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index_dir, mp, "off")
    try:
        return {q: japi.query("i", q)["results"] for q in READS}
    finally:
        jh.close()
        mp.undo()


@pytest.fixture(scope="module", params=list(CONFIGS))
def port(index_dir, request):
    holder, api = _port_api(index_dir, request.param)
    yield api, request.param
    api.executor.close()
    holder.close()


@pytest.mark.parametrize("pql", READS)
def test_same_json(port, jax_answers, pql):
    api, _ = port
    got = api.query("i", pql)
    assert json.dumps(got) == json.dumps({"results": jax_answers[pql]})


@pytest.mark.parametrize("config", list(CONFIGS))
def test_chip_mix_same_json_both_packages_same_config(index_dir, monkeypatch,
                                                      config):
    """The chip's request list, each package in the same configuration."""
    jh, japi = _jax_api(index_dir, monkeypatch, config)
    th, tapi = _port_api(index_dir, config)
    try:
        for pql in CHIP_MIX:
            assert tapi.query("i", pql) == \
                {"results": japi.query("i", pql)["results"]}, pql
    finally:
        tapi.executor.close()
        th.close()
        jh.close()


def test_default_paths_take_the_bsi_families(index_dir, jax_answers,
                                             monkeypatch):
    """The default executor answers Sum, Min/Max and range Counts through
    the batcher's sum / minmax / bsirange families (fast lane), the
    compound Count through the tree family, and repeats hit the plan
    cache."""
    holder, api = _port_api(index_dir, "default")
    fused = api.executor.fused
    seen = []
    for name in ("run_sum_plane_batch", "run_minmax_plane_batch",
                 "run_range_batch", "run_tree_counts"):
        fn = getattr(fused, name)
        monkeypatch.setattr(fused, name,
                            lambda *a, _f=fn, _n=name, **k:
                            (seen.append(_n), _f(*a, **k))[1])
    try:
        # the set plane resident: the tree path admits it
        api.query("i", "".join(f"Count(Row(f={r}))" for r in range(8)))
        for pql in ("Sum(field=amount)", "Min(field=amount)",
                    "Count(Row(amount > 2500))", "Count(Row(amount > 2500))",
                    "Count(Intersect(Row(f=1), Row(amount >= 0)))"):
            assert api.query("i", pql)["results"] == jax_answers[pql]
        stats = api.executor.serving_stats()
    finally:
        api.executor.close()
        holder.close()
    assert seen == ["run_sum_plane_batch", "run_minmax_plane_batch",
                    "run_range_batch", "run_range_batch", "run_tree_counts"]
    assert stats["fastLaneHits"] == 6 and stats["planCacheHits"] >= 1


TREES = ["Intersect(Row(f=1), Row(amount >= 0))",
         "Union(Row(f=2), Row(-100 < amount <= 100), Row(amount == 17))",
         "Intersect(Row(f=1), Row(amount > 99999))",
         "Difference(Row(f=3), Row(amount < -99999))",
         "Intersect(Row(f=1), Not(Row(amount != 5)))"]


@pytest.mark.parametrize("pql", TREES)
def test_tree_lowering_equal(index_dir, pql):
    jh, th = JHolder(index_dir).open(), THolder(index_dir).open()
    try:
        jex = JExecutor(jh, count_batch_window="off", plane_paging=False)
        tex = TExecutor(th, device="cpu", count_batch_window="off")
        want = jtree.lower_count_tree(
            jex, JCtx(jh.index("i"), tuple(range(SHARDS))),
            jparse(pql).calls[0])
        got = ttree.lower_count_tree(
            tex, TCtx(th.index("i"), tuple(range(SHARDS))),
            tparse(pql).calls[0])
        for name in ("field", "rows", "extras", "prog", "depth",
                     "cse_hits"):
            assert getattr(got, name) == getattr(want, name), name
        assert got.bsi_fields == tuple(f for f, _ in want.bsi_depths)
    finally:
        th.close()
        jh.close()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_writes_same_json(index_dir, tmp_path, monkeypatch, config):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index_dir, jdir)
    shutil.copytree(index_dir, tdir)
    jh, japi = _jax_api(jdir, monkeypatch, config)
    th, tapi = _port_api(tdir, config)
    try:
        for pql in WRITES:
            want = japi.query("i", pql)["results"]
            assert tapi.query("i", pql) == {"results": want}, pql
    finally:
        tapi.executor.close()
        th.close()
        jh.close()
    # each package reopens what the other wrote
    jh, japi = _jax_api(tdir, monkeypatch, config)
    th, tapi = _port_api(jdir, config)
    try:
        for pql in READS[:8]:
            assert tapi.query("i", pql) == \
                {"results": japi.query("i", pql)["results"]}, pql
    finally:
        tapi.executor.close()
        th.close()
        jh.close()


# ---------------------------------------------------------------------------
# store: options and bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [
    {"type": "int"}, {"type": "int", "min": 0, "max": 1000},
    {"type": "int", "min": 10, "max": 1000},
    {"type": "int", "min": -1000, "max": -10},
    {"type": "int", "min": -1_000_000, "max": 1_000_000},
    {"type": "int", "min": 5, "max": 5},
    {"type": "int", "min": 3, "max": 90, "base": 1},
    {"type": "int", "min": -7, "max": 9, "bit_depth": 12},
    {"type": "decimal", "min": -100, "max": 100, "scale": 2},
    {"type": "decimal", "scale": 3},
    {"type": "timestamp", "min": 0, "max": 1 << 32, "time_unit": "ms"},
    {"type": "timestamp", "epoch": "2000-01-01T00:00:00+00:00"},
    {"type": "set"}, {"type": "time", "time_quantum": "ymd"},
])
def test_field_options_derivation_equal(opts):
    assert asdict(TFieldOptions(**opts)) == asdict(JFieldOptions(**opts))


@pytest.mark.parametrize("opts", [
    {"type": "int", "min": 5, "max": 4},
    {"type": "timestamp", "time_unit": "minutes"},
    {"type": "time", "time_quantum": "YD"}, {"type": "nope"}])
def test_field_options_refused_alike(opts):
    with pytest.raises(ValueError):
        JFieldOptions(**opts)
    with pytest.raises(ValueError):
        TFieldOptions(**opts)


def _field_files(root: str, name: str) -> dict:
    out = {}
    base = os.path.join(root, "x", name)
    for dirpath, _, files in os.walk(base):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, base)] = fh.read()
    return out


@pytest.mark.parametrize("opts", [
    {"type": "int", "created_at": 1.0},
    {"type": "int", "min": -300, "max": 70000, "created_at": 1.0},
    {"type": "decimal", "scale": 2, "created_at": 1.0},
    {"type": "timestamp", "time_unit": "ms", "created_at": 1.0}])
def test_import_values_bytes_equal(tmp_path, opts):
    """``.meta`` (bit depth growth included), op-logs, then snapshots after
    close: byte for byte between the packages."""
    rng = np.random.default_rng(3)
    batches = []
    for n, hi in ((500, 100), (800, 70000), (300, 3)):
        cols = rng.choice(SHARDS * SW, n, replace=False).astype(np.uint64)
        cols[:20] = cols[20:40]            # repeats: the last write wins
        vals = rng.integers(-300 if hi > 3 else 0, hi, n)
        if opts["type"] == "decimal":
            vals = np.round(vals / 7.0, 2)
        if opts["type"] == "timestamp":
            vals = np.abs(vals)
        batches.append((cols, vals.tolist()))
    files = []
    for mod_holder, mod_opts, root in (
            (JHolder, JFieldOptions, str(tmp_path / "j")),
            (THolder, TFieldOptions, str(tmp_path / "t"))):
        h = mod_holder(root).open()
        f = h.create_index("x", track_existence=False).create_field(
            "v", mod_opts(**opts))
        changed = [f.import_values(c, v) for c, v in batches]
        changed.append(f.set_value(77, 5))
        changed.append(f.clear_value(int(batches[0][0][50])))
        value = f.value(int(batches[1][0][60]))
        before = _field_files(root, "v")
        h.close()
        files.append((changed, value, before, _field_files(root, "v")))
    (jc, jv, jb, ja), (tc, tv, tb, ta) = files
    assert tc == jc and tv == jv
    assert tb.keys() == jb.keys() and ta.keys() == ja.keys()
    for name in jb:
        assert tb[name] == jb[name], name
    for name in ja:
        assert ta[name] == ja[name], name


# ---------------------------------------------------------------------------
# ingest: value imports over the BSI overlay
# ---------------------------------------------------------------------------


INGEST_READS = ["Sum(field=amount)", "Min(field=amount)",
                "Max(Row(g=1), field=amount)", "Count(Row(amount > 2500))",
                "Count(Row(-100 < amount < 100))",
                "Sum(Row(g=0), field=amount)"]


def _value_batches(seed: int, n: int, k: int):
    rng = np.random.default_rng(seed)
    return [(rng.choice(SHARDS * SW, n, replace=False).tolist(),
             rng.integers(-5000, 5001, n).tolist()) for _ in range(k)]


def _post(base: str, path: str, body: bytes, ctype: str | None = None):
    req = urllib.request.Request(base + path, data=body, method="POST")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_import_values_absorbed_then_folded(index_dir, tmp_path,
                                            monkeypatch, config):
    """REST importValue batches into both packages; the port answers over
    the resident bit plane plus its BSI overlay with no rebuild, then
    after a fold, equal to the JAX package after every batch."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index_dir, jdir)
    shutil.copytree(index_dir, tdir)
    jh, japi = _jax_api(jdir, monkeypatch, config)
    th, tapi = _port_api(tdir, config, delta_compact_fraction=1.0)
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    planes = tapi.executor.planes
    field = th.index("i").field("amount")
    try:
        jb, tb = ("http://%s:%d" % s.address for s in (js, ts))
        for pql in INGEST_READS:  # planes resident
            assert tapi.query("i", pql)["results"] == \
                japi.query("i", pql)["results"]
        builds = planes.builds
        for cols, vals in _value_batches(21, 200, 3):
            body = json.dumps({"columnIDs": cols,
                               "values": vals}).encode()
            want = _post(jb, "/index/i/field/amount/importValue", body)
            assert _post(tb, "/index/i/field/amount/importValue", body) \
                == want
            for pql in INGEST_READS:
                assert tapi.query("i", pql)["results"] == \
                    japi.query("i", pql)["results"], pql
            if config == "default":
                # ("off" range Counts read the clean plane: they fold)
                ps = planes.bsi_plane_delta("i", field,
                                            tuple(range(SHARDS)))
                assert ps.delta is not None and ps.delta.n > 0
        assert planes.builds == builds and planes.delta_absorbs >= 3
        # a fold (the clean fetch), then the same answers
        tapi.query("i", "Sum(field=amount)")
        planes.bsi_plane("i", field, tuple(range(SHARDS)))
        assert planes.delta_compactions >= 1 and planes.builds == builds
        for pql in INGEST_READS + ["Percentile(field=amount, nth=50)",
                                   "Count(Intersect(Row(f=1), "
                                   "Row(amount >= 0)))"]:
            assert tapi.query("i", pql)["results"] == \
                japi.query("i", pql)["results"], pql
        # a malformed protobuf body answers the reference's 400
        errs = []
        for base in (jb, tb):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, "/index/i/field/amount/importValue", b"\x00",
                      "application/x-protobuf")
            errs.append((e.value.code, json.loads(e.value.read())))
        assert errs[0][0] == 400 and errs[1] == errs[0]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(tb, "/index/i/field/f/importValue",
                  b'{"columnIDs": [1], "values": [1]}')
        assert e.value.code == 400
    finally:
        ts.close()
        js.close()
        tapi.executor.close()
        th.close()
        jh.close()


def test_compactor_folds_bsi_overlay(index_dir, tmp_path):
    """Past the compaction fill the background compactor folds the BSI
    overlay: answers stay those of a fresh executor."""
    tdir = str(tmp_path / "t")
    shutil.copytree(index_dir, tdir)
    th, tapi = _port_api(tdir, "default", delta_compact_fraction=0.01)
    planes = tapi.executor.planes
    try:
        tapi.query("i", "Sum(field=amount)")
        builds = planes.builds
        for cols, vals in _value_batches(22, 300, 2):
            tapi.import_values("i", "amount", col_ids=cols, values=vals)
            got = [tapi.query("i", q) for q in INGEST_READS]
        assert planes.wait_compactions(60)
        assert planes.delta_compactions >= 1 and planes.builds == builds
        assert [tapi.query("i", q) for q in INGEST_READS] == got
        fresh_h, fresh = _port_api(tdir, "off")
        try:
            assert [fresh.query("i", q) for q in INGEST_READS] == got
        finally:
            fresh_h.close()
    finally:
        tapi.executor.close()
        th.close()


def test_depth_growth_rebuilds(tmp_path, monkeypatch):
    """A value past the bit depth grows it: the next read builds a new
    plane at the new depth, equal to the JAX package's answer."""
    roots = {k: str(tmp_path / k) for k in "jt"}
    for root in roots.values():
        h = JHolder(root).open()
        idx = h.create_index("i")
        idx.create_field("v", JFieldOptions(type="int", created_at=1.0))
        idx.field("v").import_values(np.arange(50, dtype=np.uint64),
                                     list(range(-25, 25)))
        h.close()
    jh, japi = _jax_api(roots["j"], monkeypatch, "default")
    th, tapi = _port_api(roots["t"], "default")
    planes = tapi.executor.planes
    qs = ["Sum(field=v)", "Max(field=v)", "Count(Row(v > 20))",
          "Count(Row(v < 1000))"]
    try:
        for q in qs:
            assert tapi.query("i", q)["results"] == \
                japi.query("i", q)["results"]
        builds = planes.builds
        for api in (japi, tapi):
            api.import_values("i", "v", col_ids=[7, SW + 3],
                              values=[100000, -3])
        assert th.index("i").field("v").options.bit_depth == 17
        for q in qs:
            assert tapi.query("i", q)["results"] == \
                japi.query("i", q)["results"], q
        assert planes.builds == builds + 1
    finally:
        tapi.executor.close()
        th.close()
        jh.close()


def _overlay_case(seed: int, n_cols: int):
    """A small bit plane, the plane with some word columns rewritten, and
    the mirror that holds those cells."""
    from test_torch_bsi import make_plane, port
    plane, _, _ = make_plane(seed, 3, 9, w=64)
    rows = plane.shape[1]
    rng = np.random.default_rng(seed)
    new, _, _ = make_plane(seed + 1, 3, 9, w=64)
    picked = rng.choice(3 * 64, n_cols, replace=False)
    folded = plane.copy()
    mirror = DeltaMirror(1 << 16)
    cells = {}
    for c in picked:
        s, w = divmod(int(c), 64)
        for r in range(rows):
            if rng.random() < 0.7 or r == 0:
                folded[s, r, w] = new[s, r, w]
                cells[(s * rows + r, w)] = int(new[s, r, w])
    mirror.absorb(cells)
    overlay = mirror.build_bsi_overlay("cpu", rows, 3)
    return port(plane), port(folded), overlay


@pytest.mark.parametrize("n_cols", [3, 5, 8])
def test_bsi_overlay_pad_lanes_contribute_nothing(n_cols):
    """base+delta through the overlay equals the folded plane for every
    BSI family, with pad lanes (``col_shard == S``) present or not."""
    from test_torch_bsi import filt, port
    plane, folded, ov = _overlay_case(30 + n_cols, n_cols)
    k_pad = 1 << (n_cols - 1).bit_length()
    assert ov.n == n_cols and ov.col_shard.shape[0] == k_pad
    assert (ov.col_shard[n_cols:] == 3).all()
    f = port(filt(4, 3, 64))
    fused = FusedCache()
    flags, filters = (False, True), (f,)
    masks = tbsi.predicate_masks(100, 9)
    specs = ((("gt",), False), (("ge", "lt"), True))
    ops = (masks, False, masks, True, masks, False, f)
    want_sum = fused.run_sum_plane_batch(folded, flags, filters)
    got_sum = fused.run_sum_plane_batch(plane, flags, filters, delta=ov)
    for k in range(2):
        assert tbsi.decode_sum_packed(got_sum[k].numpy()) == \
            tbsi.decode_sum_packed(want_sum[k].numpy())
    want_mm = fused.run_minmax_plane_batch(folded, flags, filters)
    got_mm = fused.run_minmax_plane_batch(plane, flags, filters, delta=ov)
    for k in range(2):
        def best(t):
            live = [x for x in t if x[1] > 0]
            return (min(x[0] for x in live), max(x[2] for x in live))
        assert best(tbsi.decode_minmax_packed(got_mm[k].numpy())) == \
            best(tbsi.decode_minmax_packed(want_mm[k].numpy()))
    assert torch.equal(fused.run_range_batch(plane, specs, ops, delta=ov),
                       fused.run_range_batch(folded, specs, ops))
    # the sides themselves: pad lanes leave the base filter alone and
    # carry a zero mini filter
    (_, excl), (mini, mflt) = bsi_sides(plane, None, ov)
    assert (mflt[n_cols:] == 0).all() and mini.shape == (k_pad, 11, 1)
    touched = set(zip(ov.col_shard[:n_cols].tolist(),
                      ov.col_word[:n_cols].tolist()))
    zero = {tuple(x) for x in torch.nonzero(excl == 0).tolist()}
    assert zero == touched


def test_bsi_overlay_equals_jax_overlay_answers():
    """The JAX package's BSI split (its overlay pads to 64 lanes) and the
    port's give the same Sum over the same cells."""
    import jax.numpy as jnp
    from pilosa_tpu.engine import bsi as jbsi
    from pilosa_tpu.ingest.delta import DeltaMirror as JMirror
    from pilosa_tpu.ingest.delta import bsi_sides as jsides
    plane, _, ov = _overlay_case(41, 5)
    jm = JMirror(1 << 16)
    rows = plane.shape[1]
    cells = {}
    for k in range(ov.n):
        s, w = int(ov.col_shard[k]), int(ov.col_word[k])
        for r in range(rows):
            if int(ov.col_mask[k, r]):
                cells[(s * rows + r, w)] = int(ov.col_vals[k, r]) \
                    & 0xFFFFFFFF
    jm.absorb(cells)
    jov = jm.build_bsi_overlay(jnp.asarray, rows, 3)
    jplane = jnp.asarray(plane.numpy().view(np.uint32))
    want = [jbsi.combine_sum(*jbsi.bit_counts(p, fw))
            for p, fw in jsides(jplane, None, jov)]
    got = [tbsi.combine_sum(*tbsi.bit_counts(p, fw))
           for p, fw in bsi_sides(plane, None, ov)]
    assert got == want


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------


def test_concurrent_bsi_items_cobatch(index_dir, jax_answers):
    """With a fixed window, concurrent Sum, Min/Max and range Counts over
    one bit plane share family calls (and identical ones dedupe), every
    answer equal to the JAX package's."""
    holder, api = _port_api(index_dir, "default", count_batch_window=0.05)
    ex = api.executor
    mix = ["Sum(field=amount)", "Sum(Row(g=0), field=amount)",
           "Min(field=amount)", "Max(Row(g=1), field=amount)",
           "Count(Row(amount > 2500))", "Count(Row(-100 < amount < 100))"]
    errors = []
    start = threading.Barrier(12, timeout=60)

    def client(k):
        try:
            start.wait()
            for j in range(3):
                q = mix[(k + j) % len(mix)]
                got = api.query("i", q)["results"]
                if got != jax_answers[q]:
                    errors.append((q, got))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        api.query("i", mix[0])      # the bit plane resident
        _run_threads(client, 12)
        kinds = ex.serving_stats()["kinds"]
    finally:
        ex.close()
        holder.close()
    assert not errors, errors[:3]
    for kind in ("sum", "minmax", "bsirange"):
        assert kinds[kind]["maxItems"] >= 2, kinds
        assert kinds[kind]["items"] > kinds[kind]["groups"], kinds


def test_failing_bsi_launch_reaches_every_caller(index_dir, jax_answers):
    """A BSI group whose launch raises delivers the exception to each of
    its callers (no per-item fallback), the fast lane raises to its
    caller, and the next window is served."""
    holder, api = _port_api(index_dir, "default", count_batch_window=0.05)
    ex = api.executor
    failing = threading.Event()
    failing.set()
    real = ex.fused.run_range_batch

    def flaky(*a, **k):
        if failing.is_set():
            raise RuntimeError("launch refused")
        return real(*a, **k)

    ex.fused.run_range_batch = flaky
    out: list = [None] * 6
    start = threading.Barrier(6, timeout=60)

    def client(k):
        start.wait()
        try:
            out[k] = ex.execute("i", "Count(Row(amount > 2500))")
        except Exception as e:  # noqa: BLE001 — checked below
            out[k] = e

    try:
        ex.execute("i", "Sum(field=amount)")     # plane resident
        _run_threads(client, 6)
        assert all(isinstance(g, RuntimeError) and "launch refused"
                   in str(g) for g in out), out
        failing.clear()
        assert ex.execute("i", "Count(Row(amount > 2500))") == \
            jax_answers["Count(Row(amount > 2500))"]
    finally:
        ex.close()
        holder.close()
    # the solo fast lane raises to its caller, nothing retries
    holder, api = _port_api(index_dir, "default")
    ex = api.executor
    calls = []

    def refuse(*a, **k):
        calls.append(1)
        raise RuntimeError("launch refused")

    ex.fused.run_sum_plane_batch = refuse
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            ex.execute("i", "Sum(field=amount)")
        assert len(calls) == 1
    finally:
        ex.close()
        holder.close()
