"""The port's tracing and metrics surface against ``pilosa_tpu`` on the CPU.

Both packages serve the same data (three shards of one set, one mutex,
one int and one time field, made from a seed with numpy):

- ``?profile`` span trees of a Count, a compound Count, a Count run, a
  TopN, a GroupBy, a BSI range and a time range, each twice (the plan
  cache's first and second visit), through the adaptive executor and the
  ``count_batch_window="off"`` one, equal with times and ids stripped;
- the ``X-Pilosa-Trace-Id`` header, resolvable at ``/internal/traces``,
  and the protobuf ``?profile`` 400;
- the families ``/metrics`` carries after the same REST workload equal
  to the reference's, minus the families whose machinery the port does
  not have, and the workload's deterministic counters equal through the
  "off" executor;
- every family the port emits is in the README's metrics inventory (the
  parse is this file's own copy of ``test_metrics_inventory.py``'s);
- the device-seconds quota sheds the same request with the same body.
"""

import json
import logging
import re
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.obs import Stats as JStats
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.api import proto as tproto
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.obs import Stats as TStats
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

REPO = Path(__file__).resolve().parent.parent
SW = 1 << 20
N_SHARDS = 3

# families of machinery the port does not have: XLA program compiles and
# their warm-up ladder, the Pallas fallback, and the cluster
NOT_PORTED = {
    "fused_compile_seconds", "fused_compile_seconds_total",
    "fused_programs_built_total", "fused_programs_evicted_total",
    "fused_program_count", "tree_programs_built_total",
    "fused_warmup_compile_seconds", "fused_warmup_programs_total",
    "pallas_fallback_total",
    "hint_handoff_total", "write_replicas_missed",
}
MESH_FAMILIES = ("mesh_collective_seconds", "mesh_devices",
                 "plane_shard_bytes")
# counted by both, on different builds: the reference's plane build over
# row chunks tallies no sidecar misses, the port's builder tallies every
# fragment it expands
TALLIED_APART = {"plane_cache_warm_misses_total"}

PROFILED = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Row(f=1))Count(Row(f=3))",
    "TopN(f, n=3)",
    "GroupBy(Rows(f), Rows(m))",
    "Count(Row(n > 10))",
    "Count(Row(t=1, from='2020-01-01T00:00', to='2020-01-03T00:00'))",
]


def _data():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 6, 4000)
    cols = rng.integers(0, N_SHARDS * SW, 4000)
    mcols = np.unique(rng.integers(0, N_SHARDS * SW, 600))
    mrows = rng.integers(0, 3, len(mcols))
    ncols = np.unique(rng.integers(0, N_SHARDS * SW, 300))
    nvals = rng.integers(-50, 400, len(ncols))
    return rows, cols, mrows, mcols, ncols, nvals


def _fill(api) -> None:
    rows, cols, mrows, mcols, ncols, nvals = _data()
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "m", {"type": "mutex"})
    api.create_field("i", "n", {"type": "int", "min": -100, "max": 1000})
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    api.import_bits("i", "f", row_ids=rows.tolist(), col_ids=cols.tolist())
    api.import_bits("i", "m", row_ids=mrows.tolist(), col_ids=mcols.tolist())
    api.import_values("i", "n", col_ids=ncols.tolist(),
                      values=nvals.tolist())
    api.import_bits("i", "t", row_ids=[1, 1, 1, 2],
                    col_ids=[5, SW + 6, 2 * SW + 7, 9],
                    timestamps=["2020-01-02T00:00", "2020-01-05T00:00",
                                "2020-01-01T12:00", "2020-01-02T00:00"])


def _pair(tmp_path, window: str, **kw):
    """(reference API, port API), each over its own holder of the same
    data, no trace sampling and no slow log."""
    out = []
    for H, E, A, S, name, extra in (
            (JHolder, JExecutor, JAPI, JStats, "j", {}),
            (THolder, TExecutor, TAPI, TStats, "t", {"device": "cpu"})):
        h = H(str(tmp_path / name)).open()
        ex = E(h, count_batch_window=window, stats=S(), **extra, **kw)
        api = A(h, ex, trace_sample_rate=0.0, slow_query_threshold=0.0)
        _fill(api)
        out.append(api)
    return out


def _close(apis) -> None:
    """Close the port's executor (its batcher threads end) and both
    holders; the reference's batcher threads are daemons."""
    for api in apis:
        close = getattr(api.executor, "close", None)
        if close is not None:
            close()
        api.holder.close()


def _strip(span: dict) -> dict:
    return {"name": span["name"],
            "tags": {k: v for k, v in span["tags"].items()
                     if k not in ("deviceSeconds", "deviceShare")},
            "children": [_strip(c) for c in span["children"]]}


@pytest.mark.parametrize("window", ["adaptive", "off"])
def test_profile_span_trees_equal(tmp_path, window):
    japi, tapi = apis = _pair(tmp_path, window)
    try:
        for pql in PROFILED:
            for visit in range(2):
                j = japi.query("i", pql, profile=True)
                t = tapi.query("i", pql, profile=True)
                assert t["results"] == j["results"], pql
                assert [_strip(s) for s in t["profile"]] == \
                    [_strip(s) for s in j["profile"]], (pql, visit)
                root = t["profile"][0]
                assert root["name"] == "query" and root["parentId"] is None
                assert root["traceId"] == tapi.last_trace_id()
                if window == "adaptive" and pql.startswith("Count"):
                    # a batched query is charged: its root says how much
                    # of its wall was device work
                    assert root["tags"]["deviceSeconds"] > 0
                    assert 0 < root["tags"]["deviceShare"] <= 1
    finally:
        _close(apis)


def _http(base: str, path: str, body: bytes | None = None,
          headers: dict | None = None):
    req = urllib.request.Request(base + path, data=body,
                                 headers=headers or {},
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture
def servers(tmp_path):
    apis = _pair(tmp_path, "adaptive")
    srvs = [JServer(apis[0], "127.0.0.1", 0, stats=apis[0].executor.stats),
            TServer(apis[1], "127.0.0.1", 0)]
    for s in srvs:
        s.start()
    yield [f"http://127.0.0.1:{s.address[1]}" for s in srvs], apis
    for s in srvs:
        s.close()
    _close(apis)


def test_trace_id_header_and_traces(servers):
    (jbase, tbase), _ = servers
    for base in (jbase, tbase):
        st, hdrs, body = _http(base, "/index/i/query",
                               b"Count(Row(f=1))")
        assert st == 200
        tid = hdrs["X-Pilosa-Trace-Id"]
        assert re.fullmatch(r"[0-9a-f]{16}", tid)
        assert "traceId" not in json.loads(body)
        st, hdrs, body = _http(base, "/index/i/query?profile=true",
                               b"Count(Row(f=1))")
        tid = hdrs["X-Pilosa-Trace-Id"]
        assert json.loads(body)["profile"][0]["traceId"] == tid
        st, _, body = _http(base, f"/internal/traces?trace_id={tid}")
        traces = json.loads(body)["traces"]
        assert [t["traceId"] for t in traces] == [tid]
        # errors carry no trace header
        st, hdrs, _ = _http(base, "/index/i/query", b"Nope(")
        assert st == 400 and "X-Pilosa-Trace-Id" not in hdrs
    answers = [json.loads(_http(b, "/index/i/query?profile=true",
                                b"Count(Row(f=2))")[2])
               for b in (jbase, tbase)]
    assert [_strip(s) for s in answers[1]["profile"]] == \
        [_strip(s) for s in answers[0]["profile"]]


def test_protobuf_profile_refused(servers):
    (jbase, tbase), _ = servers
    body = tproto.encode_query_request("Count(Row(f=1))")
    hdrs = {"Content-Type": tproto.CONTENT_TYPE,
            "Accept": tproto.CONTENT_TYPE}
    got = [_http(b, "/index/i/query?profile=true", body, hdrs)
           for b in (jbase, tbase)]
    assert got[1][0] == got[0][0] == 400
    assert json.loads(got[1][2]) == json.loads(got[0][2]) == {
        "error": "?profile is not supported with application/x-protobuf "
                 "responses"}
    # without ?profile the protobuf answer carries the trace header
    st, h, _ = _http(tbase, "/index/i/query", body, hdrs)
    assert st == 200 and re.fullmatch(r"[0-9a-f]{16}",
                                      h["X-Pilosa-Trace-Id"])


WORKLOAD = [
    ("query", b"Count(Row(f=1))"),
    ("query", b"Count(Row(f=1))"),
    ("query", b"Count(Row(f=1))Count(Row(f=2))Count(Row(f=3))"),
    ("query", b"Count(Union(Row(f=1), Row(m=2)))"),
    ("query", b"Count(Union(Row(f=1), Row(m=2)))"),
    # two trees in one request: both enqueue into one window
    ("query", b"Count(Union(Row(f=1), Row(m=2)))"
              b"Count(Intersect(Row(f=1), Row(m=1)))"),
    ("query", b"TopN(f, n=2)"),
    ("query", b"GroupBy(Rows(m))"),
    ("query", b"Sum(field=n)"),
    ("query", b"Count(Row(n > 10))"),
    ("query", b"Count(Row(n > 10))"),
    ("query", b"Count(Row(t=1, from='2020-01-01T00:00', "
              b"to='2020-01-03T00:00'))"),
    ("import", b'{"rowIDs": [1, 2], "columnIDs": [100, 200]}'),
    ("query", b"Count(Row(f=1))"),
    ("query", b"Set(7, f=4)"),
    ("query", b"Nope("),
]


def _families(text: str) -> dict:
    """family -> type from the ``# TYPE`` lines."""
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _counters(text: str) -> dict:
    fams = _families(text)
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{", 1)[0]
        if fams.get(name) == "counter":
            out[series] = float(value)
    return out


def _run_workload(base: str) -> str:
    for kind, body in WORKLOAD:
        path = ("/index/i/query" if kind == "query"
                else "/index/i/field/f/import")
        _http(base, path, body)
    _http(base, "/status")
    return _http(base, "/metrics")[2].decode()


def test_metric_families_equal(servers):
    (jbase, tbase), _ = servers
    jtext, ttext = _run_workload(jbase), _run_workload(tbase)
    jf, tf = _families(jtext), _families(ttext)
    skip = NOT_PORTED | TALLIED_APART
    assert {k: v for k, v in tf.items() if k not in skip} == \
        {k: v for k, v in jf.items() if k not in skip}
    for fam in ("kernel_bytes_scanned_total", "solo_fastlane_hits_total",
                "tenant_device_seconds_total", "query_device_seconds",
                "http_request_seconds", "query_stage_seconds",
                "flight_events_total"):
        assert fam in tf, fam


def test_mesh_families_equal(tmp_path):
    """Under a placement of eight blocks (the reference's 8-device CPU
    mesh, the port's ``virtual_placement(8, "cpu")``) concurrent Counts
    fill meshed windows: both packages then emit the mesh families with
    the same types, and ``mesh_devices`` reads 8 in both."""
    import jax
    from pilosa_tpu.parallel import MeshPlacement
    from pilosa_tpu_torch.virtmesh import virtual_placement
    apis = []
    for H, E, A, S, name, extra in (
            (JHolder, JExecutor, JAPI, JStats, "j",
             {"placement": MeshPlacement(jax.devices())}),
            (THolder, TExecutor, TAPI, TStats, "t",
             {"placement": virtual_placement(8, "cpu")})):
        h = H(str(tmp_path / name)).open()
        ex = E(h, stats=S(), max_concurrent=32, **extra)
        api = A(h, ex, trace_sample_rate=0.0, slow_query_threshold=0.0)
        _fill(api)
        apis.append(api)
    srvs = [JServer(apis[0], "127.0.0.1", 0, stats=apis[0].executor.stats),
            TServer(apis[1], "127.0.0.1", 0)]
    for srv in srvs:
        srv.start()
    bases = [f"http://127.0.0.1:{srv.address[1]}" for srv in srvs]
    try:
        texts = []
        for base, api in zip(bases, apis):
            for pql in (b"Count(Row(f=1))", b"Count(Row(n > 10))"):
                _http(base, "/index/i/query", pql)  # planes resident
            stats = api.executor.stats
            for _ in range(5):
                barrier = threading.Barrier(8)

                def worker():
                    barrier.wait()
                    for _ in range(4):
                        _http(base, "/index/i/query", b"Count(Row(f=1))")
                        _http(base, "/index/i/query", b"Count(Row(n > 10))")

                ts = [threading.Thread(target=worker) for _ in range(8)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(120)
                if stats.histogram_summary("mesh_collective_seconds"):
                    break
            _http(base, "/status")  # refreshes plane_shard_bytes
            texts.append(_http(base, "/metrics")[2].decode())
    finally:
        for srv in srvs:
            srv.close()
        _close(apis)
    jf, tf = (_families(t) for t in texts)
    assert {k: tf.get(k) for k in MESH_FAMILIES} == \
        {k: jf.get(k) for k in MESH_FAMILIES}
    assert all(jf.get(k) for k in MESH_FAMILIES)
    for text in texts:
        assert re.search(r"^mesh_devices 8(\.0)?$", text, re.M), text


# counters that follow from the workload alone, not from timing or from
# which thread won a race
DETERMINISTIC = ("http_requests_total", "ingest_bits_total",
                 "plan_cache_hits", "plan_cache_misses",
                 "plan_cache_invalidations", "tree_cse_hits_total")


def test_deterministic_counters_equal_off(tmp_path):
    apis = _pair(tmp_path, "off")
    srvs = [JServer(apis[0], "127.0.0.1", 0, stats=apis[0].executor.stats),
            TServer(apis[1], "127.0.0.1", 0)]
    for s in srvs:
        s.start()
    try:
        texts = [_run_workload(f"http://127.0.0.1:{s.address[1]}")
                 for s in srvs]
    finally:
        for s in srvs:
            s.close()
        _close(apis)
    jc, tc = (_counters(t) for t in texts)
    pick = [k for k in jc if k.split("{", 1)[0] in DETERMINISTIC]
    assert pick
    assert {k: tc.get(k) for k in pick} == {k: jc[k] for k in pick}


def _documented() -> tuple[set, set]:
    """(names, wildcard prefixes) of the README inventory table (the
    reference's parse, copied)."""
    text = (REPO / "README.md").read_text()
    section = text[text.index("Metrics inventory"):]
    rows = []
    in_table = False
    for line in section.splitlines():
        if line.startswith("|"):
            in_table = True
            rows.append(line)
        elif in_table:
            break
    names, wildcards = set(), set()

    def add(tok: str) -> None:
        tok = tok.strip()
        if tok.endswith("*"):
            wildcards.add(tok[:-1])
        elif tok:
            names.add(tok)

    for row in rows:
        for tok in re.findall(r"`([^`]+)`", row.split("|")[1]):
            tok = re.sub(r"\{[^}]*\}", "", tok)
            if "/" in tok:
                parts = [p.strip() for p in tok.split("/")]
                prefix = parts[0].rsplit("_", 1)[0] + "_"
                for i, seg in enumerate(parts):
                    add(seg if i == 0 or "_" in seg else prefix + seg)
            else:
                add(tok)
    return names, wildcards


def test_emitted_names_in_the_inventory():
    emit = re.compile(
        r'\.(?:count|gauge|observe|timing)\(\s*"([a-zA-Z0-9_]+)"')
    emitted = set()
    for path in (REPO / "pilosa_tpu_torch").rglob("*.py"):
        emitted.update(emit.findall(path.read_text()))
    emitted.add("query_stage_seconds")
    emitted.update(re.findall(r'"device_oom_(?:exclusive_)?retries"',
                              (REPO / "pilosa_tpu_torch" / "exec" /
                               "executor.py").read_text()))
    emitted = {e.strip('"') for e in emitted}
    names, wildcards = _documented()
    missing = {e for e in emitted if e not in names
               and not any(e.startswith(w) for w in wildcards)}
    assert not missing
    assert len(emitted) > 60


def test_device_seconds_quota_sheds_the_same_request(tmp_path):
    apis = _pair(tmp_path, "adaptive", tenant_device_seconds_quota=1e-9)
    srvs = [JServer(apis[0], "127.0.0.1", 0, stats=apis[0].executor.stats),
            TServer(apis[1], "127.0.0.1", 0)]
    for s in srvs:
        s.start()
    try:
        got = []
        for s in srvs:
            base = f"http://127.0.0.1:{s.address[1]}"
            first = _http(base, "/index/i/query", b"Count(Row(f=1))")
            second = _http(base, "/index/i/query", b"Count(Row(f=1))")
            got.append((first[0], second[0], second[1].get("Retry-After"),
                        json.loads(second[2])))
        assert got[1] == got[0]
        assert got[1][:2] == (200, 503)
        assert got[1][3]["tenantThrottled"] == {
            "tenant": "i", "quota": 1e-9, "kind": "device-seconds"}
        assert apis[1].executor.tenancy_status()["qos"]["sheds"] == {"i": 1}
    finally:
        for s in srvs:
            s.close()
        _close(apis)


def test_debug_routes(servers):
    (jbase, tbase), (japi, tapi) = servers
    tapi.slow_query_threshold = 1e-9
    for base in (jbase, tbase):
        _http(base, "/index/i/query", b"Count(Row(f=1))")
    _run_workload(tbase)  # its two-tree request rings a window's events
    jslow, tslow = (json.loads(_http(b, "/debug/slow")[2])
                    for b in (jbase, tbase))
    assert tslow["total"] > 1 and tslow["slow"][-1]["index"] == "i"
    assert tslow["slow"][-1]["path"] == "fused"
    assert set(tslow) == set(jslow) | {"slow"}
    st, _, body = _http(tbase, "/debug/flight?limit=5")
    ring = json.loads(body)
    assert st == 200 and 0 < len(ring["events"]) <= 5
    assert {"seq", "ts", "kind", "entity", "detail", "value"} == \
        set(ring["events"][0])
    assert _http(tbase, "/debug/flight?limit=x")[0] == 400
    st, hdrs, body = _http(tbase, "/debug/threads")
    assert st == 200 and b"Thread " in body
    assert threading.current_thread().name.encode() in body
    status = json.loads(_http(tbase, "/status")[2])
    assert status["costs"]["soloDispatches"] >= 1
    assert status["storageHealth"]["state"] == "healthy"
    assert status["slowQueries"]["total"] == tslow["total"]
    assert "admit" in ",".join(status["queryStages"])


def test_observability_keys_reach_the_server(tmp_path):
    """The item-10 config keys, off their defaults, reach the registry,
    the API, the scrubber, the disk governor and the logger."""
    from pilosa_tpu_torch.cli import config as tconfig
    from pilosa_tpu_torch.obs import StatsdStats
    from pilosa_tpu_torch.obs.logging import JsonFormatter
    from pilosa_tpu_torch.server import PilosaTPUServer
    cfg = tconfig.load(env={}, overrides=dict(
        bind="127.0.0.1:0", data_dir=str(tmp_path / "d"), device="cpu",
        log_format="json", stats_backend="statsd",
        statsd_address="127.0.0.1:9", trace_sample_rate=0.5,
        slow_query_threshold=2.0, scrub_interval_seconds=300.0,
        scrub_bytes_per_second=1 << 20, disk_min_free_bytes=1 << 20,
        disk_probe_seconds=2.0, diagnostics_interval=0.0))
    srv = PilosaTPUServer(cfg).open()
    try:
        assert isinstance(srv.stats, StatsdStats)
        assert srv.executor.stats is srv.stats
        assert srv.http.httpd.stats is srv.stats
        assert (srv.api.trace_sample_rate, srv.api.slow_query_threshold) \
            == (0.5, 2.0)
        assert (srv.scrubber.interval, srv.scrubber.bytes_per_second) == \
            (300.0, 1 << 20)
        assert srv.scrubber._thread is not None and srv.api.scrubber
        sh = srv.holder.storage_health
        assert (sh.min_free_bytes, sh.probe_seconds, sh.base) == \
            (1 << 20, 2.0, cfg.data_dir)
        assert isinstance(srv.logger.handlers[0].formatter, JsonFormatter)
        assert srv.diagnostics._thread is None  # 0: off
    finally:
        srv.close()
        srv.logger.handlers[0].setFormatter(logging.Formatter())
    assert srv.scrubber._thread is None
    with pytest.raises(ValueError, match="unknown stats_backend"):
        PilosaTPUServer(tconfig.load(env={}, overrides=dict(
            data_dir=str(tmp_path / "e"), device="cpu",
            stats_backend="carrier-pigeon")))
