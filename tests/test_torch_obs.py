"""The port's observability package against ``pilosa_tpu.obs`` on the CPU.

The same scripted calls go through both packages and the outputs compare
whole:

- the Prometheus text, byte for byte (classic and OpenMetrics), after
  counts, gauges, observes, ``set_buckets``, escaped labels, exemplars,
  label-cardinality folding and the registry snapshots;
- ``apportion`` bit for bit, its shares summing exactly to the total;
- ``CostLedger`` payloads, recent seconds and trace seconds, and
  ``FlightRecorder`` snapshots and incident dumps, under a patched
  ``time.monotonic``;
- ``traceparent`` parsing, injection and extraction, the lite tracer's
  slow root, the slow-query log and the ``StageTimer`` spans;
- ``JsonFormatter`` lines with and without an active trace id;
- ``StatsdStats`` packets, received on a localhost socket.
"""

import json
import logging
import socket
import time

import numpy as np
import pytest

from pilosa_tpu.obs import flight as jflight
from pilosa_tpu.obs import ledger as jledger
from pilosa_tpu.obs import logging as jlogging
from pilosa_tpu.obs import metrics as jmetrics
from pilosa_tpu.obs import tracing as jtracing
from pilosa_tpu_torch.obs import diagnostics as tdiag
from pilosa_tpu_torch.obs import flight as tflight
from pilosa_tpu_torch.obs import ledger as tledger
from pilosa_tpu_torch.obs import logging as tlogging
from pilosa_tpu_torch.obs import metrics as tmetrics
from pilosa_tpu_torch.obs import tracing as ttracing

class _Clock:
    """A settable clock patched over ``time.monotonic`` / ``time.time``."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _script(mod) -> "jmetrics.Stats":
    st = mod.Stats()
    st.count("plain_total")
    st.count("plain_total", 2.5)
    st.count("labelled_total", 3, kind="count", tenant="a")
    st.count("labelled_total", 1, kind="tree", tenant='we"ird\\na\nme')
    st.gauge("g", 7)
    st.gauge("g", 1.25, device="cuda:0")
    st.set_buckets("bytes_hist", mod.BYTE_BUCKETS)
    st.set_buckets("bytes_hist", mod.BYTE_BUCKETS)  # idempotent
    st.set_buckets("items", mod.COUNT_BUCKETS)
    for v in (0.00005, 0.003, 0.003, 0.7, 30.0):
        st.observe("lat_seconds", v, stage="read")
    st.observe("lat_seconds", 0.02, trace_id="abc123", stage="plan")
    st.observe("lat_seconds", 99.0, trace_id='x"y', stage="plan")
    for v in (100.0, 5e6, 1e12):
        st.observe("bytes_hist", v)
    st.timing("items", 3.0, trace_id="t1", kind="count")
    st.observe("items", 1000.0, kind="count")
    for i in range(40):  # past the 32-tenant bound: the rest fold
        st.count("tenant_shed_total", 1, tenant=f"t{i}")
        st.count("tenant_device_seconds_total", 0.5, tenant=f"t{i % 35}")
    st.count("tenant_shed_total", 1, tenant="other")
    st.bound_label("custom_total", "who", 2)
    for w in ("a", "b", "c", "a"):
        st.count("custom_total", 1, who=w)
    return st


def test_prometheus_text_byte_equal(monkeypatch):
    clock = _Clock(1700000000.123456)
    monkeypatch.setattr(time, "time", clock)
    j, t = _script(jmetrics), _script(tmetrics)
    for om in (False, True):
        assert t.prometheus_text(openmetrics=om) == \
            j.prometheus_text(openmetrics=om)
    assert t.snapshot() == j.snapshot()
    assert t.full_snapshot() == j.full_snapshot()
    for name in ("lat_seconds", "bytes_hist", "items", "absent"):
        assert t.histogram_summary(name) == j.histogram_summary(name)
    assert 'tenant_shed_total{tenant="other"} 9' in t.prometheus_text()
    assert 'tenant="we\\"ird\\\\na\\nme"' in t.prometheus_text()
    assert '# {trace_id="x\\"y"} 99.0 1700000000.123' in \
        t.prometheus_text(openmetrics=True)
    assert t.prometheus_text(openmetrics=True).endswith("# EOF\n")
    assert tmetrics.BOUNDED_LABELS == jmetrics.BOUNDED_LABELS
    assert tmetrics.STAGE_METRIC == jmetrics.STAGE_METRIC


@pytest.mark.parametrize("buckets, match", [
    ((), "ascending"), ((2.0, 1.0), "ascending"), ((1.0, 1.0), "ascending")])
def test_set_buckets_refusals_equal(buckets, match):
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError, match=match):
            mod.Stats().set_buckets("h", buckets)


def test_rebucketing_refused_equally():
    errs = []
    for mod in (jmetrics, tmetrics):
        st = mod.Stats()
        st.observe("h", 0.1)
        with pytest.raises(ValueError) as ei:
            st.set_buckets("h", (1.0, 2.0))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_nop_stats_surface():
    for mod in (jmetrics, tmetrics):
        nop = mod.NopStats()
        nop.count("a")
        nop.gauge("b", 1)
        nop.observe("c", 1.0, trace_id="x")
        nop.timing("d", 1.0)
        nop.set_buckets("e", (1.0,))
        nop.bound_label("f", "g")
    j, t = jmetrics.NopStats(), tmetrics.NopStats()
    assert (t.snapshot(), t.full_snapshot(), t.prometheus_text(),
            t.histogram_summary("x")) == \
        (j.snapshot(), j.full_snapshot(), j.prometheus_text(),
         j.histogram_summary("x"))


def test_stage_timer_spans_and_exemplars(monkeypatch):
    clock = _Clock(5.0)
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "time", _Clock(1.0))
    out = []
    for mmod, tmod in ((jmetrics, jtracing), (tmetrics, ttracing)):
        clock.t = 5.0
        st = mmod.Stats()
        tracer = tmod.Tracer()
        with tracer.span("query", index="i") as root:
            timer = mmod.StageTimer(st, tracer=tracer)
            for stage, dt in (("admit", 0.001), ("parse", 0.25),
                              ("read", 3.0)):
                clock.t += dt
                timer.mark(stage)
            clock.t += 1.0
            timer.reset()
        tree = root.to_json()
        out.append(([(c["name"], c["durationUs"])
                     for c in tree["children"]],
                    st.prometheus_text(openmetrics=True)
                    .replace(root.trace_id, "TID")))
    assert out[0] == out[1]
    lite = ttracing.LiteTracer("feed")
    timer = tmetrics.StageTimer(tmetrics.Stats(), tracer=lite)
    assert timer.trace_id == "feed"


@pytest.mark.parametrize("seed", range(8))
def test_apportion_bit_equal_and_exact(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 7, 64, 257):
        total = float(rng.random() * 10.0 ** int(rng.integers(-6, 3)))
        kind = rng.integers(0, 3)
        if kind == 0:
            weights = rng.integers(0, 1 << 30, n).tolist()
        elif kind == 1:
            weights = (rng.random(n) * 1e9).tolist()
        else:
            weights = [0] * n
        j = jledger.apportion(total, weights)
        t = tledger.apportion(total, weights)
        assert [x.hex() for x in t] == [float(x).hex() for x in j]
        if n:
            acc = 0.0
            for x in t:
                acc += x
            assert acc == total


def _charge(mod, clock):
    st = (jmetrics if mod is jledger else tmetrics).Stats()
    led = mod.CostLedger(stats=st, decay_seconds=30.0)
    rng = np.random.default_rng(7)
    for w in range(60):
        clock.t += 0.37
        entries = [(f"t{int(rng.integers(0, 9))}",
                    ("count", "tree", "rowcounts")[int(rng.integers(0, 3))],
                    f"i/f{int(rng.integers(0, 4))}" if w % 5 else "",
                    int(rng.integers(0, 1 << 24)),
                    f"tr{w % 7}" if w % 3 == 0 else None)
                   for _ in range(int(rng.integers(1, 6)))]
        led.charge_window(float(rng.random() * 0.01), entries)
        led.charge_solo("t1", "selcounts", "i/f0", 0.002 * w, 4096 * w,
                        trace_id="solo" if w % 2 else None)
    led.charge_window(1.0, [])
    return led, st


def test_cost_ledger_equal(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setattr(time, "time", _Clock(1.0))
    j, jst = _charge(jledger, clock)
    clock.t = 1000.0
    t, tst = _charge(tledger, clock)
    for k in (1, 3, 5, 50):
        assert t.payload(k) == j.payload(k)
    for tenant in ("t0", "t1", "t8", "nobody"):
        assert t.recent_seconds(tenant) == j.recent_seconds(tenant)
    for tid in ("tr0", "solo", "none", None):
        assert t.trace_seconds(tid) == j.trace_seconds(tid)
    assert tst.prometheus_text(openmetrics=True) == \
        jst.prometheus_text(openmetrics=True)
    # the port compiles nothing per query shape: note_compile books none
    t.note_compile("count", 1.0, True)
    assert t.payload()["compileCount"] == 0
    assert tledger.NULL_LEDGER.payload() == jledger.NULL_LEDGER.payload()


def test_query_context_thread_local():
    import threading
    tledger.set_query_context("idx", trace_id="abc")
    tledger.set_plane_context("idx/f")
    seen = []
    th = threading.Thread(target=lambda: seen.append(
        tledger.query_context()))
    th.start()
    th.join(5)
    assert tledger.query_context() == ("idx", "idx/f", "abc")
    assert seen == [("", "", None)]
    tledger.clear_query_context()
    assert tledger.query_context() == ("", "", None)


def _fly(mod, clock, dump_dir):
    st = (jmetrics if mod is jflight else tmetrics).Stats()
    fr = mod.FlightRecorder(capacity=64, dump_dir=dump_dir, stats=st)
    paths = []
    for i in range(150):
        clock.t += 0.5
        fr.record(("enqueue", "dispatch", "readback", "deliver")[i % 4],
                  f"w{i}", "" if i % 3 else "detail", float(i))
        if i in (10, 11, 40, 41, 120):
            paths.append(fr.incident("quarantine", f"w{i}", "dispatch"))
    return fr, st, paths


def test_flight_recorder_equal(monkeypatch, tmp_path):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setattr(time, "time", _Clock(2.0))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    j, jst, jpaths = _fly(jflight, clock, jd)
    clock.t = 1000.0
    t, tst, tpaths = _fly(tflight, clock, td)
    for limit in (None, 10, 1000):
        js, ts = j.snapshot(limit), t.snapshot(limit)
        assert ts["dumps"] == [p.replace(jd, td) for p in js["dumps"]]
        ts.pop("dumps"), js.pop("dumps")
        assert ts == js
    assert tpaths == [p.replace(jd, td) if p else p for p in jpaths]
    for jp, tp in zip(j.snapshot()["dumps"], t.snapshot()["dumps"]):
        assert json.load(open(tp)) == json.load(open(jp)) | {
            "dumps": [p.replace(jd, td)
                      for p in json.load(open(jp))["dumps"]]}
    assert tst.prometheus_text() == jst.prometheus_text()
    assert tflight.NULL_FLIGHT.snapshot() == jflight.NULL_FLIGHT.snapshot()


@pytest.mark.parametrize("value", [
    None, "", "00-abc-def-01", "00-abc-def", "00-xyz-def-01",
    "00--def-01", "00-abc--01", "00-ABCdef0123-00000000-02",
    "00-1_2-ab-01", "a-b-c-d-e", "00-0x12-ab-01"])
def test_parse_traceparent_equal(value):
    assert ttracing.parse_traceparent(value) == \
        jtracing.parse_traceparent(value)


def test_traceparent_round_trip():
    for src, dst in ((ttracing, jtracing), (jtracing, ttracing),
                     (ttracing, ttracing)):
        tracer = src.Tracer()
        with tracer.span("coordinator") as root:
            for sampled, flags in ((True, "01"), (False, "02")):
                headers = {}
                tracer.inject(headers, sampled=sampled)
                assert headers[src.TRACEPARENT] == \
                    f"00-{root.trace_id}-{root.span_id}-{flags}"
                peer = dst.Tracer()
                with peer.extract(headers, "peer", node="n") as leg:
                    assert leg.trace_id == root.trace_id
                    assert leg.parent_id == root.span_id
                assert [s.name for s in peer.finished()] == ["peer"]
        lite = src.LiteTracer("0123456789abcdef")
        headers = {}
        lite.inject(headers)
        assert dst.parse_traceparent(headers[src.TRACEPARENT]) == \
            ("0123456789abcdef", "00000000", "00")
        with dst.Tracer().extract({"traceparent": "bad"}, "x") as s:
            assert s.parent_id is None


def test_lite_slow_root_and_slow_log(monkeypatch):
    monkeypatch.setattr(time, "time", _Clock(3.0))
    out = []
    for mod in (jtracing, ttracing):
        lite = mod.LiteTracer("feedbeef00000000")
        lite.stage("stage.admit", 0.001)
        lite.stage("stage.read", 0.5)
        root = lite.slow_root("query", 2.0, index="i", liteTrace=True)
        tree = root.to_json()
        log = mod.SlowQueryLog(keep=2)
        for ms in (5.0, 9.0, 7.0):
            log.record({"durationMs": ms})
        out.append(({k: v for k, v in tree.items()
                     if k not in ("spanId", "children")},
                     [(c["name"], c["durationUs"], c["parentId"] ==
                       tree["spanId"]) for c in tree["children"]],
                     log.entries(), log.summary()))
    assert out[0] == out[1]
    null = ttracing.NULL_TRACER
    with null.span("x") as s:
        assert s is None
    assert null.finished() == [] and null.current_span() is None


def test_current_trace_id_thread_local():
    ttracing.set_current_trace_id("abc")
    try:
        assert ttracing.current_trace_id() == "abc"
    finally:
        ttracing.set_current_trace_id(None)
    ids = {ttracing.fast_trace_id() for _ in range(1000)}
    assert len(ids) == 1000 and all(len(i) == 16 for i in ids)
    assert len(ttracing.fast_span_id()) == 8


def _record(msg: str, trace: str | None = None) -> logging.LogRecord:
    rec = logging.LogRecord("pilosa_tpu_torch.api", logging.WARNING,
                            __file__, 1, msg, ("x",), None)
    rec.created = 1700000000.5
    rec.msecs = 500.0
    if trace is not None:
        rec.traceId = trace
    return rec


def test_json_formatter_lines(monkeypatch):
    monkeypatch.setenv("TZ", "UTC")
    time.tzset()
    jf, tf = jlogging.JsonFormatter(), tlogging.JsonFormatter()
    assert tf.format(_record("a %s")) == jf.format(_record("a %s"))
    assert json.loads(tf.format(_record("a %s")))["message"] == "a x"
    assert "traceId" not in json.loads(tf.format(_record("a %s")))
    # the record's own id wins over the thread's active one
    assert tf.format(_record("b %s", "rec")) == jf.format(_record("b %s",
                                                                  "rec"))
    jtracing.set_current_trace_id("active")
    ttracing.set_current_trace_id("active")
    try:
        line = tf.format(_record("c %s"))
        assert line == jf.format(_record("c %s"))
        assert json.loads(line)["traceId"] == "active"
    finally:
        jtracing.set_current_trace_id(None)
        ttracing.set_current_trace_id(None)
    with pytest.raises(ValueError, match="unknown log_format"):
        tlogging.get_logger("pilosa_tpu_torch.test_obs", fmt="xml")
    log = tlogging.get_logger("pilosa_tpu_torch.test_obs", fmt="json")
    assert isinstance(log.handlers[0].formatter, tlogging.JsonFormatter)
    log = tlogging.get_logger("pilosa_tpu_torch.test_obs", fmt="text")
    assert not isinstance(log.handlers[0].formatter,
                          tlogging.JsonFormatter)


def test_statsd_packets_equal():
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.settimeout(5.0)
    port = sink.getsockname()[1]
    try:
        got = []
        for mod in (jmetrics, tmetrics):
            st = mod.StatsdStats("127.0.0.1", port, prefix="pilosa")
            st.count("hits_total", 2, kind="count")
            st.gauge("depth", 3)
            st.observe("query_seconds", 0.0125, call="Count")
            st.observe("kernel_window_bytes", 4096.0)
            st.close()
            got.append([sink.recv(512) for _ in range(4)])
        assert got[0] == got[1]
        assert got[1][2] == b"pilosa.query_seconds:12.5|ms|#call:Count"
    finally:
        sink.close()


def test_diagnostics_payload(tmp_path):
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import Holder
    h = Holder(str(tmp_path)).open()
    h.create_index("i").create_field("f")
    ex = Executor(h, device="cpu", stats=tmetrics.Stats())
    try:
        ex.execute("i", "Set(3, f=1)")
        pay = tdiag.build_payload(h, stats=ex.stats,
                                  slow_log=ttracing.SlowQueryLog(),
                                  executor=ex)
        assert (pay["numIndexes"], pay["numFields"], pay["numShards"],
                pay["fieldTypes"], pay["deviceKind"]) == \
            (1, 1, 1, {"set": 1}, "cpu")
        assert "mesh" not in pay and pay["costs"]["windows"] == 0
        sent = []
        d = tdiag.Diagnostics(h, interval=0.02, send=sent.append,
                              executor=ex).start()
        deadline = time.monotonic() + 5
        while not sent and time.monotonic() < deadline:
            time.sleep(0.01)
        d.close()
        assert sent and sent[0]["version"] == pay["version"]
    finally:
        ex.close()
        h.close()
