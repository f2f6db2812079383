"""The arithmetic of the end-to-end numbers, the roofline's byte count
from each template's shapes, the trace reduction, and the per-layer
readers."""

import numpy as np
import pytest

from benchmark import harness, roofline, trace, traffic
from benchmark.metrics import (admission_wait_ms, batch_items_mean,
                               device_idle_pct, kernels_per_request,
                               kernels_roofline)


def window_of(sends_and_lat, end=10.0):
    recs = [{"t_send": s, "t_done": s + lat, "result": []}
            for s, lat in sends_and_lat]
    return {"start": 0.0, "end": end, "last": max(r["t_done"] for r in recs),
            "records": recs}


def test_rate_and_percentiles_over_every_request():
    # 100 requests of 10 ms, then one stalled for 5 s that returns after
    # the close: it counts in the tail, not in the rate
    reqs = [(0.05 * i, 0.010) for i in range(100)] + [(9.0, 5.0)]
    m = harness.end_to_end(window_of(reqs), setup_s=42.0)
    assert m["requests_per_s"]["value"] == pytest.approx(100 / 10.0)
    lat = [10.0] * 100 + [5000.0]
    assert m["latency_p50_ms"]["value"] == pytest.approx(np.percentile(lat, 50))
    assert m["latency_p95_ms"]["value"] == pytest.approx(np.percentile(lat, 95))
    assert m["setup_s"]["value"] == 42.0


def test_a_stall_moves_the_tail_of_all_requests():
    # 40 of 200 requests wait behind a stall: a p95 over every request
    # sees them, a median of chunk percentiles would not
    reqs = [(0.04 * i, 0.020) for i in range(160)] + \
        [(6.4 + 0.01 * i, 1.5) for i in range(40)]
    m = harness.end_to_end(window_of(reqs), setup_s=1.0)
    assert m["latency_p95_ms"]["value"] == pytest.approx(1500.0)
    assert m["latency_p50_ms"]["value"] == pytest.approx(20.0)


def test_errors_are_not_completed_requests():
    win = window_of([(0.0, 0.1), (0.1, 0.1)])
    win["records"][1]["error"] = "ExecutionError: boom"
    del win["records"][1]["result"]
    m = harness.end_to_end(win, setup_s=1.0)
    assert m["requests_per_s"]["value"] == pytest.approx(0.1)


def shapes(name):
    cfg = harness.load_config(name)
    depth = {f: (max(1, (s["max"] - s.get("base", 0)).bit_length()), False)
             for f, s in cfg["fields"].items() if s["type"] == "int"}
    return cfg, depth


# rows per shard each template reads: set rows named or grouped, the
# BSI fields' bit planes and existence row
TEMPLATE_ROWS = {
    ("taxi.dash-c32", "q1_topn_cab"): 2 + 18,
    ("taxi.dash-c32", "q2_avg_by_passengers"): 10 + 18,
    ("taxi.dash-c32", "q3_passengers_year"): 10 + 7 + 18,
    ("taxi.dash-c32", "q4_passengers_year_distance"): 10 + 7 + 64 + 18,
    ("ssb.flights-c1", "q1_1"): 1 + 3 + 7 + 25,
    ("ssb.flights-c1", "q1_2"): 1 + 3 + 7 + 25,
    ("ssb.flights-c1", "q1_3"): 1 + 1 + 3 + 7 + 25,
    ("ssb.flights-c1", "q3_1"): 25 + 25 + 6 + 1 + 1 + 25,
    ("ssb.flights-c1", "q4_1"): 7 + 25 + 1 + 1 + 2 + 25 + 18,
}
CONFIG = {"taxi.dash-c32": "nyc-taxi", "ssb.flights-c1": "ssb-sf10"}


@pytest.mark.parametrize("mix_name,template", sorted(TEMPLATE_ROWS))
def test_roofline_bytes_from_shapes(mix_name, template):
    cfg, depth = shapes(CONFIG[mix_name])
    mix = traffic.load(mix_name)
    t = next(t for t in mix["templates"] if t["name"] == template)
    req = traffic.request(t, np.random.default_rng(1))
    rows = TEMPLATE_ROWS[(mix_name, template)]
    assert roofline.request_rows(req["calls"], cfg["fields"], depth) == rows
    assert roofline.request_bytes(req["calls"], cfg["fields"], depth,
                                  cfg["shards"]) == \
        rows * cfg["shards"] * (1 << 17)


def test_trace_reduce_unions_and_gaps():
    ev = [(0, 100, "void row_counts_kernel<int>(int const*)"),
          (50, 150, "Memcpy DtoH (Device -> Pinned)"),
          (400, 500, "count_kernel"),
          (500, 600, "count_kernel"),
          (1000, 1100, "row_counts_kernel")]
    s = trace.reduce(ev)
    assert s["busy_s"] == pytest.approx(450e-9)
    assert s["kernels"] == 4 and s["records"] == 5
    assert s["idle_gaps"][0] == ["after count_kernel, before row_counts_kernel",
                                 pytest.approx(400e-9)]
    assert s["idle_gaps"][1][1] == pytest.approx(250e-9)
    assert dict((n, t) for n, t in s["device_ops"])["row_counts_kernel"] == \
        pytest.approx(200e-9)


def test_per_layer_readers():
    ctx = {"completed": 10, "records": [],
           "hist": {"query_queue_wait_seconds": {"count": 4, "sum": 0.2},
                    "batcher_window_items": {"count": 5, "sum": 350.0}},
           "trace": {"busy_s": 0.5, "window_s": 2.0, "kernels": 300,
                     "records": 320},
           "request_bytes": [int(3.35e12 * 0.01)] * 10}
    assert admission_wait_ms.read(ctx) == pytest.approx(50.0)
    assert batch_items_mean.read(ctx) == pytest.approx(70.0)
    assert kernels_per_request.read(ctx) == pytest.approx(30.0)
    assert kernels_roofline.read(ctx) == pytest.approx(20.0)
    assert device_idle_pct.read(ctx) == pytest.approx(75.0)
    empty = dict(ctx, hist={}, trace=None)
    for reader in (admission_wait_ms, batch_items_mean, kernels_per_request,
                   kernels_roofline, device_idle_pct):
        assert reader.read(empty) is None
