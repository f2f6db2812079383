"""Metrics: counters, gauges and histograms with Prometheus text export
(``pilosa_tpu.obs.metrics``'s registry, byte for byte).

One in-process registry exports the Prometheus text format at
``/metrics``; :class:`StatsdStats` also emits every observation as a
DogStatsD UDP packet, and :class:`NopStats` records nothing.  The
registry keeps the reference's surface:

- per-family bucket sets (:meth:`Stats.set_buckets`) with the byte,
  count, ratio and depth presets;
- label-value escaping per the exposition rules (``\\``, ``"``,
  newline), so a PQL-derived label cannot corrupt the document;
- trace exemplars: ``observe(..., trace_id=...)`` keeps the latest
  (trace id, value, timestamp) per bucket, rendered after the bucket line
  in OpenMetrics output only;
- label-cardinality caps (:data:`BOUNDED_LABELS`): the first K values of a
  user-controlled label keep their own series, later ones fold into
  ``other``.

- the cluster fan-in (:func:`render_cluster_metrics`): per-node
  :meth:`Stats.full_snapshot` payloads merge into one document, counters
  and gauges per node under a ``node`` label, histograms bucket-wise
  (exact) when every node agrees on the family's buckets.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
            0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# per-family bucket presets (set_buckets): device-plane telemetry spans
# bytes (KB..64GB scans), item counts (coalescing-window occupancy) and
# ratios (window fill) — none of which the latency default resolves
BYTE_BUCKETS = (1 << 10, 1 << 14, 1 << 17, 1 << 20, 1 << 23, 1 << 26,
                1 << 28, 1 << 30, 1 << 32, 1 << 34, 1 << 36)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
RATIO_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
# small structural depths (compound-tree nesting): the interesting
# range is 1..8 with single-level resolution at the shallow end
DEPTH_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

# StageTimer's default histogram family (referenced via this constant,
# not a literal call site)
STAGE_METRIC = "query_stage_seconds"

# families emitted only in the cluster document (by
# render_cluster_metrics, not through a registry)
CLUSTER_NODE_UP = "cluster_metrics_node_up"
CLUSTER_STALE_NODES = "cluster_metrics_stale_nodes"

# -- label-cardinality bounds ------------------------------------------------
#
# A label whose values the USER controls (tenant = index name, peer =
# node id) grows one series per distinct value forever — a churny
# multi-tenant deployment turns `tenant_shed_total{tenant}` into an
# unbounded scrape.  Families listed here are capped at registry level:
# the first K distinct values of the bounded label keep their own
# series, every later value folds into the ``other`` series.  The
# capped rollup stays a faithful TOTAL (folding moves a count between
# series, it never drops one); per-entity detail for the long tail
# lives in the /status blocks, which are maps, not scrape series.
#
# Module constant (family -> (label, K)) so the metrics-inventory
# cardinality lint can enforce that every family with a user-controlled
# label declares its bound here.
DEFAULT_LABEL_BOUND = 32
OTHER_LABEL = "other"
BOUNDED_LABELS: dict[str, tuple[str, int]] = {
    # per-tenant families (tenant = index name: user-controlled)
    "tenant_shed_total": ("tenant", DEFAULT_LABEL_BOUND),
    "tenant_device_seconds_total": ("tenant", DEFAULT_LABEL_BOUND),
    "tenant_device_bytes_total": ("tenant", DEFAULT_LABEL_BOUND),
    # per-plane ledger rollup (plane key derives from index/field names)
    "plane_device_seconds_total": ("plane", DEFAULT_LABEL_BOUND),
    # per-peer families (node ids churn across replaces/restarts)
    "hint_handoff_total": ("peer", 64),
    "hint_appended_total": ("peer", 64),
    "hint_replay_dropped_total": ("peer", 64),
    "hint_backlog_ops": ("peer", 64),
    "read_failover_total": ("peer", 64),
    "read_hedged_total": ("peer", 64),
    "peer_breaker_state": ("peer", 64),
    "breaker_transitions_total": ("peer", 64),
}


def escape_label_value(v) -> str:
    """Prometheus exposition escaping for label VALUES: backslash,
    double quote, and newline must be escaped or a hostile value (PQL
    text, a key) corrupts the whole scrape document."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Stats:
    """In-process metrics registry.  Thread-safe; cheap enough for the
    query path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._gauges: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._hists: dict[str, dict[tuple, list]] = defaultdict(dict)
        # family -> bucket upper bounds (default _BUCKETS); latched at
        # set_buckets or first observation
        self._hist_buckets: dict[str, tuple] = {}
        # (family, labels-key) -> {bucket index: (trace_id, value, ts)}
        # — the LATEST exemplar per bucket, bounded per series by the
        # bucket count
        self._exemplars: dict[tuple, dict[int, tuple]] = {}
        # label-cardinality caps: (family, label) -> K, plus the set of
        # label values already holding their own series
        self._label_bounds: dict[tuple, int] = {
            (fam, lab): k for fam, (lab, k) in BOUNDED_LABELS.items()}
        self._label_seen: dict[tuple, set] = {}

    def bound_label(self, name: str, label: str,
                    top_k: int = DEFAULT_LABEL_BOUND) -> None:
        """Cap one family's label cardinality: the first ``top_k``
        distinct values of ``label`` keep their own series; later
        values fold into the ``other`` series.  Families in
        :data:`BOUNDED_LABELS` are capped automatically."""
        with self._lock:
            self._label_bounds[(name, label)] = int(top_k)

    def _cap(self, name: str, labels: dict) -> dict:
        """Fold over-cardinality label values into ``other``.  Caller
        holds the lock; ``labels`` is the call's own kwargs dict, so
        in-place mutation is safe."""
        for lab in labels:
            k = self._label_bounds.get((name, lab))
            if k is None:
                continue
            v = str(labels[lab])
            if v == OTHER_LABEL:
                continue
            seen = self._label_seen.setdefault((name, lab), set())
            if v in seen:
                continue
            if len(seen) < k:
                seen.add(v)
            else:
                labels[lab] = OTHER_LABEL
        return labels

    # -- StatsClient surface (reference parity) -----------------------------

    def count(self, name: str, value: float = 1, **labels) -> None:
        with self._lock:
            key = _labels_key(self._cap(name, labels) if labels
                              else labels)
            m = self._counters[name]
            m[key] = m.get(key, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = _labels_key(self._cap(name, labels) if labels
                              else labels)
            self._gauges[name][key] = value

    def set_buckets(self, name: str, buckets: tuple) -> None:
        """Declare one family's histogram buckets (upper bounds,
        ascending).  Idempotent for an identical bucket set; changing
        the buckets of a family that already holds observations raises
        — re-bucketing recorded counts would fabricate history."""
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets for {name!r} must be ascending "
                             f"and non-empty: {buckets!r}")
        with self._lock:
            cur = self._hist_buckets.get(name)
            if cur == b:
                return
            if cur is not None or self._hists.get(name):
                raise ValueError(
                    f"histogram family {name!r} already has "
                    f"{'buckets' if cur else 'observations'}; cannot "
                    f"re-bucket")
            self._hist_buckets[name] = b

    def observe(self, name: str, value: float, trace_id: str | None = None,
                **labels) -> None:
        """Histogram observation (reference: Timing/Histogram).  With
        ``trace_id``, the observation is remembered as the bucket's
        OpenMetrics exemplar — the join point between a latency bucket
        and ``/internal/traces?trace_id=`` (the lite serving path
        passes its cheap trace id here; cost is one tuple write)."""
        with self._lock:
            key = _labels_key(self._cap(name, labels) if labels
                              else labels)
            buckets = self._hist_buckets.setdefault(name, _BUCKETS)
            h = self._hists[name].get(key)
            if h is None:
                # [bucket counts..., +inf count, sum, total]
                h = self._hists[name][key] = \
                    [0] * (len(buckets) + 1) + [0.0, 0]
            for i, ub in enumerate(buckets):
                if value <= ub:
                    h[i] += 1
                    break
            else:
                i = len(buckets)
                h[i] += 1
            h[-2] += value
            h[-1] += 1
            if trace_id is not None:
                ex = self._exemplars.get((name, key))
                if ex is None:
                    ex = self._exemplars[(name, key)] = {}
                ex[i] = (trace_id, value, time.time())

    def timing(self, name: str, seconds: float,
               trace_id: str | None = None, **labels) -> None:
        self.observe(name, seconds, trace_id=trace_id, **labels)

    # -- export -------------------------------------------------------------

    def histogram_summary(self, name: str) -> dict:
        """Compact per-label view of one histogram family:
        ``{label: {count, sum, mean}}`` — the ``diagnostics`` dump of
        the per-stage query timers (``query_stage_seconds``), cheap
        enough for ``/status`` consumers that don't want the full
        Prometheus bucket text.  Distinct label SETS that stringify to
        the same display label (a collision) merge their counts and
        sums rather than silently dropping one."""
        with self._lock:
            fam = self._hists.get(name)
            if not fam:
                return {}
            merged: dict[str, list] = {}
            for key, h in sorted(fam.items()):
                label = ",".join(f"{k}={v}" for k, v in key) or "total"
                agg = merged.setdefault(label, [0, 0.0])
                agg[0] += h[-1]
                agg[1] += h[-2]
            return {label: {"count": n, "sum": round(s, 6),
                            "mean": round(s / n, 6) if n else 0.0}
                    for label, (n, s) in merged.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {n: dict(m) for n, m in self._counters.items()},
                "gauges": {n: dict(m) for n, m in self._gauges.items()},
            }

    def full_snapshot(self) -> dict:
        """JSON-ready dump of the WHOLE registry — counters, gauges and
        histograms with their bucket boundaries and raw (non-cumulative)
        bucket counts."""
        with self._lock:
            hists = {}
            for name, fam in self._hists.items():
                b = self._hist_buckets.get(name, _BUCKETS)
                hists[name] = {
                    "buckets": [float(x) for x in b],
                    "series": [{"labels": dict(key),
                                "counts": [int(c) for c in h[:len(b) + 1]],
                                "sum": float(h[-2]), "count": int(h[-1])}
                               for key, h in sorted(fam.items())]}
            return {
                "counters": {n: [{"labels": dict(k), "value": v}
                                 for k, v in sorted(m.items())]
                             for n, m in self._counters.items()},
                "gauges": {n: [{"labels": dict(k), "value": v}
                               for k, v in sorted(m.items())]
                           for n, m in self._gauges.items()},
                "histograms": hists,
            }

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """Registry as exposition text.  The default is the classic
        Prometheus 0.0.4 format, which allows ONLY ``metric value
        [timestamp]`` per sample line — an exemplar suffix there is a
        parse error that fails the whole scrape — so exemplars render
        ONLY when ``openmetrics`` is set (the ``/metrics`` handler sets
        it when the scraper's Accept header negotiates
        ``application/openmetrics-text``); OpenMetrics output also
        terminates with the mandatory ``# EOF``."""
        out = []
        with self._lock:
            for name, m in sorted(self._counters.items()):
                out.append(f"# TYPE {name} counter")
                for key, v in sorted(m.items()):
                    out.append(f"{name}{_fmt_labels(key)} {v}")
            for name, m in sorted(self._gauges.items()):
                out.append(f"# TYPE {name} gauge")
                for key, v in sorted(m.items()):
                    out.append(f"{name}{_fmt_labels(key)} {v}")
            for name, m in sorted(self._hists.items()):
                buckets = self._hist_buckets.get(name, _BUCKETS)
                out.append(f"# TYPE {name} histogram")
                for key, h in sorted(m.items()):
                    ex = (self._exemplars.get((name, key), {})
                          if openmetrics else {})
                    _render_hist_series(out, name, key, buckets,
                                        h, h[-2], h[-1], ex)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


def _render_hist_series(out: list, name: str, key: tuple, buckets,
                        counts, total: float, count: int,
                        exemplars: dict | None = None) -> None:
    """Append one histogram series' cumulative ``_bucket`` /``_sum``/
    ``_count`` exposition lines — the ONE place the cumulative-bucket
    encoding lives.
    ``counts`` holds raw per-bucket counts with +Inf at index
    ``len(buckets)`` (trailing entries beyond that are ignored, so a
    registry's ``[counts..., sum, total]`` row can be passed as-is)."""
    ex = exemplars or {}
    cum = 0
    for i, ub in enumerate(buckets):
        cum += counts[i]
        lk = key + (("le", repr(ub)),)
        out.append(f"{name}_bucket{_fmt_labels(lk)} {cum}"
                   + _fmt_exemplar(ex.get(i)))
    cum += counts[len(buckets)]
    lk = key + (("le", "+Inf"),)
    out.append(f"{name}_bucket{_fmt_labels(lk)} {cum}"
               + _fmt_exemplar(ex.get(len(buckets))))
    out.append(f"{name}_sum{_fmt_labels(key)} {total}")
    out.append(f"{name}_count{_fmt_labels(key)} {count}")


def _fmt_exemplar(ex: tuple | None) -> str:
    """OpenMetrics exemplar suffix for a bucket line:
    ``# {trace_id="..."} value timestamp`` (empty when the bucket has
    never seen a traced observation)."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
            f"{value} {round(ts, 3)}")


# -- cluster fan-in merge -----------------------------------------------------


def render_cluster_metrics(snaps: dict[str, dict],
                           stale: list[str] | tuple = ()) -> str:
    """ONE Prometheus document for the whole fleet from per-node
    :meth:`Stats.full_snapshot` payloads.

    Merge rules (the single-pane contract):

    - counters and gauges keep ONE series per node, the node id added
      as a ``node`` label (summing gauges across nodes is usually
      wrong, and per-node counters are what an operator diffs);
    - histograms merge BUCKET-WISE across nodes per label set — counts
      are element-wise sums, so the merged distribution is exact, not
      an approximation — whenever every reporting node agrees on the
      family's bucket boundaries; disagreeing families (version skew
      mid-rollout) degrade to per-node series under a ``node`` label
      instead of fabricating a merge;
    - ``cluster_metrics_node_up{node=...}`` gauges (1 fetched / 0
      stale) and a ``cluster_metrics_stale_nodes`` count make partial
      documents self-describing: a scrape through a dead peer is
      degraded, never an error.
    """
    out = [f"# pilosa-tpu cluster metrics: {len(snaps)} node(s), "
           f"{len(stale)} stale"]
    out.append(f"# TYPE {CLUSTER_NODE_UP} gauge")
    for nid in sorted(snaps):
        out.append(f'{CLUSTER_NODE_UP}{{node="{escape_label_value(nid)}"}} 1')
    for nid in sorted(stale):
        out.append(f'{CLUSTER_NODE_UP}{{node="{escape_label_value(nid)}"}} 0')
    out.append(f"# TYPE {CLUSTER_STALE_NODES} gauge")
    out.append(f"{CLUSTER_STALE_NODES} {len(stale)}")

    for kind in ("counters", "gauges"):
        names = sorted({n for s in snaps.values() for n in s.get(kind, {})})
        ptype = "counter" if kind == "counters" else "gauge"
        for name in names:
            out.append(f"# TYPE {name} {ptype}")
            for nid in sorted(snaps):
                for series in snaps[nid].get(kind, {}).get(name, []):
                    key = _node_key(series["labels"], nid)
                    out.append(f"{name}{_fmt_labels(key)} "
                               f"{series['value']}")

    names = sorted({n for s in snaps.values()
                    for n in s.get("histograms", {})})
    for name in names:
        per_node = {nid: s["histograms"][name]
                    for nid, s in snaps.items()
                    if name in s.get("histograms", {})}
        out.append(f"# TYPE {name} histogram")
        bucket_sets = {tuple(f["buckets"]) for f in per_node.values()}
        if len(bucket_sets) == 1:
            buckets = bucket_sets.pop()
            merged: dict[tuple, list] = {}
            for fam in per_node.values():
                for series in fam["series"]:
                    key = _labels_key(series["labels"])
                    agg = merged.setdefault(
                        key, [[0] * (len(buckets) + 1), 0.0, 0])
                    for i, c in enumerate(series["counts"]):
                        agg[0][i] += c
                    agg[1] += series["sum"]
                    agg[2] += series["count"]
            for key, (counts, total, n) in sorted(merged.items()):
                _render_hist_series(out, name, key, buckets,
                                    counts, total, n)
        else:
            # bucket disagreement (mid-rollout skew): keep per-node
            # series — a wrong merge would be worse than no merge
            for nid in sorted(per_node):
                fam = per_node[nid]
                for series in fam["series"]:
                    _render_hist_series(out, name,
                                        _node_key(series["labels"], nid),
                                        fam["buckets"], series["counts"],
                                        series["sum"], series["count"])
    return "\n".join(out) + "\n"


def _node_key(labels: dict, nid: str) -> tuple:
    """Labels-key with the node id merged in (the fan-in's ``node``
    label wins over any same-named label a series already carried)."""
    return _labels_key({**labels, "node": nid})


class StatsdStats(Stats):
    """Stats registry that ALSO emits every observation as a statsd
    UDP packet (reference: ``statsd.go#statsdClient`` behind the
    StatsClient interface).  DogStatsD wire format with tag support::

        pilosa.query_seconds:12.3|ms|#call:Count

    Subclassing keeps the in-process registry authoritative —
    ``/metrics`` Prometheus text and ``/status`` summaries are
    unchanged; statsd is an additional sink.  Emission is fire-and-
    forget UDP: a missing/slow collector can never stall the serving
    path (send errors are counted, not raised)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "pilosa"):
        super().__init__()
        import socket
        self._addr = (host, port)
        self._prefix = (prefix + ".") if prefix else ""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self.send_errors = 0

    @staticmethod
    def _tags(labels: dict) -> str:
        if not labels:
            return ""
        inner = ",".join(f"{k}:{v}" for k, v in sorted(labels.items()))
        return "|#" + inner

    def _emit(self, name: str, value, kind: str, labels: dict) -> None:
        pkt = (f"{self._prefix}{name}:{value}|{kind}"
               f"{self._tags(labels)}").encode()
        try:
            self._sock.sendto(pkt, self._addr)
        except OSError:
            self.send_errors += 1

    def count(self, name: str, value: float = 1, **labels) -> None:
        super().count(name, value, **labels)
        self._emit(name, value, "c", labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        super().gauge(name, value, **labels)
        self._emit(name, value, "g", labels)

    def observe(self, name: str, value: float, trace_id: str | None = None,
                **labels) -> None:
        super().observe(name, value, trace_id=trace_id, **labels)
        # statsd timers are milliseconds by convention (exemplars have
        # no statsd encoding; they live in the in-process registry) —
        # but only ``*_seconds`` families carry seconds; item-count,
        # ratio and byte histograms ship as DogStatsD histograms with
        # the raw value (a 1 GiB window is not a 1e12 ms timer)
        if name.endswith("_seconds"):
            self._emit(name, round(value * 1000.0, 6), "ms", labels)
        else:
            self._emit(name, value, "h", labels)

    def close(self) -> None:
        self._sock.close()


class NopStats:
    """No-op client (reference: ``nopStatsClient``)."""

    def count(self, *a, **k):
        pass

    def gauge(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def timing(self, *a, **k):
        pass

    def set_buckets(self, *a, **k):
        pass

    def bound_label(self, *a, **k):
        pass

    def histogram_summary(self, name):
        return {}

    def snapshot(self):
        return {"counters": {}, "gauges": {}}

    def full_snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def prometheus_text(self, openmetrics: bool = False):
        return ""


class StageTimer:
    """Per-request overhead attribution: ``mark(stage)`` charges the
    monotonic time since the previous mark to that stage as one
    ``query_stage_seconds{stage=...}`` histogram observation.

    Stages on the serving path: ``admit`` (execution-slot acquisition +
    recovery gate), ``parse`` (PQL text → AST), ``plan`` (AST → leaf
    arrays/program structure, incl. plan-cache validation), ``dispatch``
    (program enqueue), ``read`` (device → host; on batcher-coalesced
    requests the whole coalesced wait — window + dispatch + read — is
    charged here, there is no per-request dispatch to time), and
    ``assemble`` (host result construction).  The per-stage sums are
    the per-stage attribution of the serving path's overhead.

    With a ``tracer`` attached, every mark ALSO lands as a completed
    ``stage.<name>`` child span under the innermost open span of the
    traced query — the per-stage children a distributed profile tree
    carries on every node (no-op outside any span) — and the query's
    trace id (a LiteTracer's cheap id, or the open root span's) rides
    every observation as the bucket's exemplar, so a slow bucket on
    ``/metrics`` names a trace an operator can resolve whenever the
    retention policy kept it (sampled/profiled/slow-captured — a fast
    unsampled query's exemplar id was never ring-buffered)."""

    __slots__ = ("_stats", "_metric", "_last", "tracer", "trace_id")

    def __init__(self, stats, metric: str = STAGE_METRIC,
                 tracer=None):
        self._stats = stats
        self._metric = metric
        self.tracer = tracer
        tid = getattr(tracer, "trace_id", None)
        if tid is None and tracer is not None:
            cur = tracer.current_span()
            tid = cur.trace_id if cur is not None else None
        self.trace_id = tid
        self._last = time.perf_counter()

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self._stats.observe(self._metric, now - self._last,
                            trace_id=self.trace_id, stage=stage)
        if self.tracer is not None:
            self.tracer.stage("stage." + stage, now - self._last)
        self._last = now

    def reset(self) -> None:
        """Restart the clock without charging anything (skip a gap that
        belongs to no stage)."""
        self._last = time.perf_counter()
