"""The port's protobuf codec and REST protobuf surface against
``pilosa_tpu``'s on the CPU.

- every encoder byte-equal to the reference's over the same inputs, and
  each package decoding the other's bytes to the same values: query
  requests and responses (every result shape), import and importValue
  requests, import responses; ids past 2^31 and near 2^40, negative BSI
  values through zigzag, packed fields;
- the same queries through both executors encode to the same
  QueryResponse bytes;
- REST: protobuf ``/query`` (answers, errors, Extract's refusal) byte for
  byte, and protobuf ``/import`` / ``/importValue`` with an
  ``X-Pilosa-Op-Id`` header: the same ``changed`` and the same fragment
  bytes in both packages.
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
from pilosa_tpu.api import proto as jproto
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import result_to_json as j_to_json
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.api import proto as tproto
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as t_to_json
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
CT = "application/x-protobuf"
BIG = (1 << 40) + 12345          # a column id near 2^40


def _both(name: str, *a, **k) -> bytes:
    """One encoder of each package on the same inputs: equal bytes."""
    jb = getattr(jproto, name)(*a, **k)
    tb = getattr(tproto, name)(*a, **k)
    assert tb == jb, name
    return jb


def _cross(name: str, raw: bytes):
    """Each package decodes the bytes to the same value."""
    jv = getattr(jproto, name)(raw)
    tv = getattr(tproto, name)(raw)
    assert tv == jv, name
    return jv


def test_query_request_equal():
    rng = np.random.default_rng(1)
    for pql, shards in (("Count(Row(f=1))", None),
                        ("TopN(f, n=5)", [0, 1, 954, 1 << 20]),
                        ('Row(k="zé")', rng.integers(0, 1 << 31, 50).tolist()),
                        ("", [])):
        raw = _both("encode_query_request", pql, shards, index="i")
        assert _cross("decode_query_request", raw) == \
            (pql, shards if shards else None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_import_requests_equal(seed):
    rng = np.random.default_rng(seed)
    n = 500
    rows = rng.integers(0, 1 << 20, n).astype(np.uint64)
    cols = np.concatenate([rng.integers(0, 1 << 31, n // 2),
                           BIG + rng.integers(0, 1 << 20, n - n // 2)]) \
        .astype(np.uint64)
    ts = rng.integers(1_600_000_000, 1_700_000_000, n).tolist()
    for kw in ({"row_ids": rows, "col_ids": cols},
               {"row_ids": rows.tolist(), "col_ids": cols.tolist(),
                "timestamps": ts, "clear": True},
               {"row_keys": [f"r{i}" for i in range(n)],
                "col_keys": [f"c{i}é" for i in range(n)],
                "timestamps": ["2021-02-03T04:05"] * n}):
        raw = _both("encode_import_request", index="i", field="f", **kw)
        got = _cross("decode_import_request", raw)
        if "row_ids" in kw:
            assert got["row_ids"] == [int(r) for r in kw["row_ids"]]
            assert got["col_ids"] == [int(c) for c in kw["col_ids"]]
            assert max(got["col_ids"]) > (1 << 40)
        else:
            assert got["row_keys"] == kw["row_keys"]
        assert got["clear"] == kw.get("clear", False)
    cols = (BIG + rng.integers(0, 1000, n)).tolist()
    for vals in (rng.integers(-1_000_000, 1_000_001, n).tolist(),
                 [-1_000_000] * n, [0.5 * v for v in range(-5, 5)],
                 ["2021-01-01T00:00", "2021-01-02T00:00"]):
        raw = _both("encode_import_value_request", index="i", field="v",
                    col_ids=cols[:len(vals)], values=vals)
        got = _cross("decode_import_value_request", raw)
        assert got["values"] == vals and got["col_ids"] == cols[:len(vals)]
    for bad in ([True, False], [1, "a"]):
        for mod in (jproto, tproto):
            with pytest.raises(ValueError):
                mod.encode_import_value_request(col_ids=[1, 2], values=bad)
    for changed, err in ((0, ""), (4096, ""), (-3, "x"), (1 << 40, "")):
        raw = _both("encode_import_response", changed, err)
        assert _cross("decode_import_response", raw)["changed"] == changed


RESULTS = [
    None, True, False, 0, 7, (1 << 40) + 3,
    {"columns": [0, 5, (1 << 31) + 1, BIG]},
    {"columns": [], "rowAttrs": {"a": 1}},
    {"keys": ["a", "bé"]}, {"keys": []},
    {"columns": [3], "attrs": {"3": {"x": "y"}}},
    [{"id": 3, "count": 10}, {"id": BIG, "count": 1}],
    [{"key": "k1", "count": 2}],
    {"value": -1_000_000, "count": 3}, {"value": 2.5, "count": 1},
    {"value": 0, "count": 0},
    {"rows": [1, 2, 1 << 33]},
    [{"group": [{"field": "f", "rowID": 1}, {"field": "g", "rowKey": "x"}],
      "count": 4, "agg": -1_000_000}],
    [{"group": [{"field": "f", "rowID": 0}], "count": 1}],
    {"values": [-1_000_000, -1, 0, 999_999]}, {"values": [0.5, -2.25]},
]


def test_query_response_shapes_equal():
    raw = _both("encode_query_response", RESULTS)
    got = _cross("decode_query_response", raw)
    assert len(got["results"]) == len(RESULTS)
    raw = _both("encode_query_response", err="field 'nope' not found")
    assert _cross("decode_query_response", raw)["error"] == \
        "field 'nope' not found"
    for mod in (jproto, tproto):
        with pytest.raises(ValueError, match="Extract"):
            mod.encode_query_response([{"fields": [], "columns": []}])
        with pytest.raises(ValueError):
            mod.decode_query_response(b"\x0a\xff")


# -- through both executors ---------------------------------------------------


@pytest.fixture(scope="module")
def index_src(tmp_path_factory):
    """Index ``i`` over three shards and one near column 2^32: a set field
    ``f``, BSI fields ``v`` (-1000 .. 1000: the queries' Min/Max descents
    stay short on the CPU) and ``w`` (-1,000,000 .. 1,000,000: the value
    imports), a keyed field ``k``, written through the reference's
    API."""
    root = str(tmp_path_factory.mktemp("proto") / "src")
    h = JHolder(root).open()
    api = JAPI(h, JExecutor(h))
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "v", {"type": "int", "min": -1000, "max": 1000})
    api.create_field("i", "w", {"type": "int", "min": -1_000_000,
                                "max": 1_000_000})
    api.create_field("i", "k", {"keys": True})
    rng = np.random.default_rng(3)
    cols = np.concatenate([rng.choice(3 * SW, 4000, replace=False),
                           (1 << 32) + np.arange(7)]).astype(np.uint64)
    api.import_bits("i", "f", row_ids=rng.integers(0, 6, len(cols)).tolist(),
                    col_ids=cols.tolist())
    api.import_values("i", "v", col_ids=cols[:3000].tolist(),
                      values=rng.integers(-1000, 1001, 3000).tolist())
    api.import_values("i", "w", col_ids=cols[:500].tolist(),
                      values=rng.integers(-1_000_000, 1_000_001,
                                          500).tolist())
    api.import_bits("i", "k", row_keys=[f"seg{i % 3}" for i in range(600)],
                    col_ids=cols[:600].tolist())
    h.close()
    return root


QUERIES = [
    "Count(Row(f=1))", "Row(f=2)", "TopN(f, n=3)", "TopN(k, n=2)",
    'Row(k="seg1")', "Sum(field=v)", "Min(field=v)", "Max(Row(f=1), field=v)",
    "Rows(f)", "GroupBy(Rows(k), Rows(f), limit=7)",
    "Distinct(Row(f=0), field=v)", "IncludesColumn(Row(f=1), column=5)",
    "Percentile(field=v, nth=50)", "Count(Row(v < -500))",
    "Sum(Row(f=2), field=w)",
]


@pytest.fixture
def both_apis(index_src, tmp_path):
    roots = {}
    for pkg in ("j", "t"):
        roots[pkg] = str(tmp_path / pkg)
        shutil.copytree(index_src, roots[pkg])
    jh = JHolder(roots["j"]).open()
    th = THolder(roots["t"]).open()
    japi = JAPI(jh, JExecutor(jh), trace_sample_rate=0.0,
                slow_query_threshold=0.0)
    tapi = TAPI(th, TExecutor(th, device="cpu"))
    yield japi, tapi, roots
    tapi.executor.close()
    th.close()
    jh.close()


def test_executor_answers_encode_equal(both_apis):
    japi, tapi, _ = both_apis
    for pql in QUERIES:
        jres = [j_to_json(r) for r in japi.executor.execute("i", pql)]
        tres = [t_to_json(r) for r in tapi.executor.execute("i", pql)]
        assert tres == jres, pql
        assert tproto.encode_query_response(tres) == \
            jproto.encode_query_response(jres), pql


# -- REST ---------------------------------------------------------------------


def _request(base: str, path: str, body: bytes, headers: dict):
    req = urllib.request.Request(base + path, data=body, method="POST")
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def servers(both_apis):
    japi, tapi, roots = both_apis
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    yield (("http://%s:%d" % js.address, "http://%s:%d" % ts.address),
           roots, tapi)
    ts.close()
    js.close()


def _same(bases, path, body, headers) -> tuple:
    got = [_request(b, path, body, headers) for b in bases]
    assert got[1] == got[0], (path, got)
    return got[0]


def test_rest_protobuf_query_equal(servers):
    bases, _, _ = servers
    proto_both = {"Content-Type": CT, "Accept": CT}
    for pql in QUERIES + ["Count(Row(nope=1))", "Row(f=1"]:
        for shards in ((None, [0, 2]) if pql in QUERIES[:3] else (None,)):
            body = jproto.encode_query_request(pql, shards)
            status, ctype, raw = _same(bases, "/index/i/query", body,
                                       proto_both)
            assert ctype == CT
            dec = tproto.decode_query_response(raw)
            assert (status == 200) == ("error" not in dec), (pql, dec)
    # a protobuf request answered in JSON
    body = jproto.encode_query_request("Count(Row(f=3))TopN(f, n=2)")
    status, _, raw = _same(bases, "/index/i/query", body,
                           {"Content-Type": CT})
    assert status == 200 and "results" in json.loads(raw)
    # a JSON request answered in protobuf, and Extract's refusal in
    # protobuf with the JSON surface's status
    status, _, raw = _same(bases, "/index/i/query", b"Count(Row(f=1))",
                           {"Accept": CT})
    assert status == 200
    status, ctype, raw = _same(
        bases, "/index/i/query", b"Extract(Row(f=1), Rows(f))",
        {"Accept": CT})
    assert status == 400 and ctype == CT
    assert "Extract" in tproto.decode_query_response(raw)["error"]
    # ?timeout= validation
    for bad in ("nan", "-1", "x"):
        status, _, raw = _same(bases, f"/index/i/query?timeout={bad}",
                               b"Count(Row(f=1))", {})
        assert status == 400 and b"bad timeout" in raw


def test_rest_protobuf_imports_with_op_id_equal(servers):
    """Protobuf imports carrying ``X-Pilosa-Op-Id``: the same answers,
    then the same fragment bytes (a single node applies every delivery,
    a repeated op id included)."""
    bases, roots, tapi = servers
    rng = np.random.default_rng(9)
    plane_hits = tapi.query("i", "Count(Row(f=1))")  # resident plane
    assert plane_hits["results"][0] > 0
    cols = np.concatenate([rng.integers(0, 3 * SW, 4096),
                           (1 << 32) + rng.integers(0, 64, 32)])
    rows = rng.integers(0, 6, len(cols))
    body = jproto.encode_import_request(row_ids=rows, col_ids=cols)
    for op in ("op-1", "op-1", "op-2"):
        hdr = {"Content-Type": CT, "X-Pilosa-Op-Id": op}
        status, _, raw = _same(bases, "/index/i/field/f/import", body, hdr)
        assert status == 200
    status, ctype, raw = _same(bases, "/index/i/field/f/import",
                               jproto.encode_import_request(
                                   row_ids=[5], col_ids=[BIG], clear=True),
                               {"Content-Type": CT, "Accept": CT,
                                "X-Pilosa-Op-Id": "op-3"})
    assert status == 200 and ctype == CT
    vals = rng.integers(-1_000_000, 1_000_001, 1024)
    vals[:8] = -1_000_000
    vcols = rng.integers(0, 3 * SW, 1024)
    body = jproto.encode_import_value_request(col_ids=vcols,
                                              values=vals.tolist())
    status, _, raw = _same(bases, "/index/i/field/w/importValue", body,
                           {"Content-Type": CT, "X-Pilosa-Op-Id": "op-4"})
    assert status == 200 and json.loads(raw)["changed"] > 0
    status, _, raw = _same(bases, "/index/i/field/w/importValue", b"\x00",
                           {"Content-Type": CT})
    assert status == 400
    for pql in ("Count(Row(f=1))", "TopN(f, n=6)", "Sum(field=w)",
                "Count(Row(w == -1000000))"):
        _same(bases, "/index/i/query", pql.encode(), {})
    tapi.executor.planes.wait_compactions(60)
    jfiles, tfiles = _tree_files(roots["j"]), _tree_files(roots["t"])
    assert sorted(tfiles) == sorted(jfiles)
    skip = {"i/.meta", "i/_exists/.meta"}
    assert [k for k in jfiles
            if k not in skip and not k.startswith("i/_keys")
            and jfiles[k] != tfiles[k]] == []
