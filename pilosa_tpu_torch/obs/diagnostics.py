"""Diagnostics: a periodic anonymized usage snapshot
(``pilosa_tpu.obs.diagnostics``'s).

Opt-in (``diagnostics_interval`` > 0): the reporter builds the payload and
hands it to a pluggable ``send`` callable; the default sink writes it to
the logger at debug level.  Counts only, never names or keys.  An executor
serving over a mesh placement adds its ``mesh`` block (devices, shard
axis, resident bytes per device, padding shards); a cluster node's payload
has the cluster's member count and its ``clusterHealth`` and
``writeHealth`` counts (never peer ids).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch import __version__


def build_payload(holder, stats=None, slow_log=None,
                  executor=None, cluster=None) -> dict:
    """Anonymized usage snapshot: index, field and shard counts, field
    types, with ``cluster`` its member count, suspect peers, open
    breakers and hint backlog, and with ``stats`` the per-stage query
    summary
    (``query_stage_seconds``), with ``slow_log`` the slow-query counters
    (never PQL text), with ``executor`` the card's name and count, its
    mesh block under a placement, the tenancy counts and the cost ledger's
    totals (no tenant names)."""
    n_fields = 0
    n_shards = 0
    field_types: dict[str, int] = {}
    for idx in list(holder.indexes.values()):
        for fname, f in list(idx.fields.items()):
            if fname.startswith("_"):
                continue
            n_fields += 1
            field_types[f.options.type] = \
                field_types.get(f.options.type, 0) + 1
        n_shards += len(idx.available_shards())
    payload = {
        "version": __version__,
        "numIndexes": len(holder.indexes),
        "numFields": n_fields,
        "numShards": n_shards,
        "fieldTypes": field_types,
        "numNodes": len(cluster.member_ids()) if cluster else 1,
    }
    if cluster is not None:
        try:
            peers = cluster.health_payload().get("peers", [])
            payload["clusterHealth"] = {
                "peers": len(peers),
                "suspect": sum(1 for p in peers if p.get("suspect")),
                "breakersOpen": sum(1 for p in peers
                                    if p.get("breaker") == "open")}
        except Exception:  # noqa: BLE001 — diagnostics never break serving
            pass
        try:
            wh = cluster.write_health_payload()
            payload["writeHealth"] = {
                "hintedHandoff": bool(wh.get("hintedHandoff")),
                "backlogOps": int(wh.get("hintBacklogOps", 0)),
                "bulkOps": int(wh.get("hintBulkOps", 0)),
                "hintedPeers": len(wh.get("hintedPeers", ())),
                "oldestSeconds": float(wh.get("hintOldestSeconds", 0.0))}
        except Exception:  # noqa: BLE001
            pass
    if stats is not None:
        try:
            payload["queryStages"] = stats.histogram_summary(
                "query_stage_seconds")
        except Exception:  # noqa: BLE001 — diagnostics never break serving
            pass
    if slow_log is not None:
        try:
            payload["slowQueries"] = slow_log.summary()
        except Exception:  # noqa: BLE001
            pass
    if executor is not None:
        try:
            import torch
            dev = executor.device
            if dev.type == "cuda":
                payload["deviceKind"] = torch.cuda.get_device_name(dev)
                payload["numDevices"] = torch.cuda.device_count()
            else:
                payload["deviceKind"] = "cpu"
                payload["numDevices"] = 1
        except Exception:  # noqa: BLE001
            pass
        try:
            mesh = executor.mesh_status()
            if mesh is not None:
                payload["mesh"] = mesh
        except Exception:  # noqa: BLE001 — diagnostics never break serving
            pass
        try:
            ten = executor.tenancy_status()
            tenants = ten.get("tenants", {})
            payload["tenancy"] = {
                "paging": bool(ten.get("paging")),
                "tenants": len(tenants),
                "residentPages": sum(int(t.get("residentPages", 0))
                                     for t in tenants.values()),
                "pageIns": int(ten.get("pageIns", 0)),
                "evictions": int(ten.get("evictions", 0)),
                "sheds": int(ten.get("qos", {}).get("shedTotal", 0)),
            }
        except Exception:  # noqa: BLE001
            pass
        try:
            costs = executor.cost_status()
            payload["costs"] = {
                "windows": int(costs.get("windows", 0)),
                "soloDispatches": int(costs.get("soloDispatches", 0)),
                "deviceSecondsTotal": float(
                    costs.get("deviceSecondsTotal", 0.0)),
                "bytesScannedTotal": int(costs.get("bytesScannedTotal", 0)),
                "compileSecondsTotal": float(
                    costs.get("compileSecondsTotal", 0.0)),
                "compileCount": int(costs.get("compileCount", 0)),
                "tenants": int(costs.get("trackedTenants", 0)),
                "shapes": int(costs.get("trackedShapes", 0)),
                "planes": int(costs.get("trackedPlanes", 0)),
            }
        except Exception:  # noqa: BLE001
            pass
    return payload


class Diagnostics:
    """Periodic reporter; off unless ``interval`` > 0."""

    def __init__(self, holder, interval: float = 0.0, send=None,
                 logger=None, stats=None, slow_log=None, executor=None,
                 cluster=None):
        self.holder = holder
        self.cluster = cluster
        self.stats = stats
        self.slow_log = slow_log
        self.executor = executor
        self.interval = interval
        self.send = send or self._log_sink
        self.logger = logger
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _log_sink(self, payload: dict) -> None:
        if self.logger is not None:
            self.logger.debug("diagnostics: %s", payload)

    def start(self) -> "Diagnostics":
        if self.interval > 0:
            self._thread = threading.Thread(target=self._loop,
                                            name="pilosa-torch-diagnostics",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.send(build_payload(self.holder, stats=self.stats,
                                        slow_log=self.slow_log,
                                        executor=self.executor,
                                        cluster=self.cluster))
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
