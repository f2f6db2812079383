"""Replicated bulk import through the breaker-aware write path
(``pilosa_tpu.ingest.bulk``'s).

Plain routing (``API._route_to_owners``, kept for value imports) forwards
every shard batch blindly to its owners: a dead replica fails the batch,
a saturated one hangs it, and nothing is durably queued for rejoin.
This coordinator gives bit and roaring imports the failure contract of
PQL writes:

- owners are split by the breaker-aware reachable set
  (``dist._write_reachable``): known-dead owners are durably HINTED
  up front (hint-before-apply), targets that die mid-apply hand off
  after the surviving legs, and a peer with pending hints receives new
  batches only BEHIND its backlog (one ordered stream per peer);
- every shard batch carries a unique 128-bit **op id**; receivers dedup
  against the durable ``IdWindow`` (duplicate delivery — internode
  retries, replayed hints — is a no-op);
- additive imports (``clear=False``) are best-effort like ``Set``
  (a missed replica converges via hints/AAE); clearing imports are
  strict like ``Clear`` (a replica that missed the clear would
  resurrect bits through union-merge AAE) and refuse with the
  structured 503 ``writeUnavailable`` body when handoff can't cover;
- hinted batches replay through ``/internal/hints/replay`` as
  ``kind: "import"`` records (:func:`apply_import_hint`), in append
  order with the PQL hints around them — the AAE-defers-to-hints
  ordering rule covers bulk ops for free (records carry field+shards).

Local applies use the oplog batched-append API: one fsync-coalesced
``SyncBatch`` per import batch (see ``store/oplog.py``).
"""

from __future__ import annotations

import base64
import os

import numpy as np

from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.store.view import VIEW_STANDARD


def apply_import_hint(api, op: dict) -> int:
    """Apply one replayed ``kind: "import"`` hint record locally (the
    receive half of bulk handoff).  Dedup by op id happens in the
    replay endpoint before this is called."""
    imp = op["import"]
    if imp.get("mode") == "roaring":
        return api.import_roaring(
            op["index"], op["field"], int(imp["shard"]),
            base64.b64decode(imp["blob"]),
            view=imp.get("view", VIEW_STANDARD),
            clear=bool(imp.get("clear", False)), direct=True)
    return api.import_bits(
        op["index"], op["field"], row_ids=imp["rows"],
        col_ids=imp["cols"], timestamps=imp.get("timestamps"),
        clear=bool(imp.get("clear", False)), direct=True)


class BulkImporter:
    """Shard-batch coordinator for replicated bulk imports (cluster
    mode only; single-node applies stay inside :class:`API`)."""

    def __init__(self, api, cluster):
        self.api = api
        self.cluster = cluster

    # -- public -------------------------------------------------------------

    def import_bits(self, index: str, field: str, rows: np.ndarray,
                    cols: np.ndarray, timestamps, clear: bool) -> int:
        """Pre-translated (row, col[, ts]) pairs → one replicated op per
        touched shard; returns the primary's changed count, like the
        reference import orchestration."""
        from pilosa_tpu_torch.api import proto
        shards = cols // np.uint64(SHARD_WIDTH)
        changed = 0
        for shard in np.unique(shards):
            m = shards == shard
            sub_rows = [int(r) for r in rows[m]]
            sub_cols = [int(c) for c in cols[m]]
            sub_ts = ([timestamps[i] for i in np.nonzero(m)[0]]
                      if timestamps is not None else None)
            op_id = os.urandom(16).hex()
            path = f"/index/{index}/field/{field}/import"

            def encode():
                return proto.encode_import_request(
                    row_ids=sub_rows, col_ids=sub_cols,
                    timestamps=sub_ts, clear=clear)

            def json_body():
                return {"rowIDs": sub_rows, "columnIDs": sub_cols,
                        "timestamps": sub_ts, "clear": clear}

            changed += self._shard_op(
                index, field, int(shard),
                op_name="ImportClear" if clear else "Import",
                op_id=op_id, additive=not clear,
                apply_local=lambda: self.api.import_bits(
                    index, field, row_ids=sub_rows, col_ids=sub_cols,
                    timestamps=sub_ts, clear=clear, direct=True,
                    op_id=op_id),
                forward=self._forwarder(path, op_id, encode, json_body),
                hint_payload={"mode": "bits", "rows": sub_rows,
                              "cols": sub_cols, "timestamps": sub_ts,
                              "clear": clear})
        return changed

    def import_roaring(self, index: str, field: str, shard: int,
                       blob: bytes, view: str, clear: bool) -> int:
        """One serialized roaring image → one replicated shard op."""
        op_id = os.urandom(16).hex()
        qs = f"?view={view}" + ("&clear=1" if clear else "")
        path = (f"/index/{index}/field/{field}/import-roaring/"
                f"{shard}{qs}")

        def forward(client):
            return client._do(
                "POST", path, blob,
                content_type="application/octet-stream",
                headers={"X-Pilosa-Direct": "1",
                         "X-Pilosa-Op-Id": op_id})["changed"]

        return self._shard_op(
            index, field, shard,
            op_name="ImportClear" if clear else "Import",
            op_id=op_id, additive=not clear,
            apply_local=lambda: self.api.import_roaring(
                index, field, shard, blob, view=view, clear=clear,
                direct=True, op_id=op_id),
            forward=forward,
            hint_payload={"mode": "roaring", "shard": shard,
                          "view": view, "clear": clear,
                          "blob": base64.b64encode(blob).decode()})

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _forwarder(path: str, op_id: str, encode, json_body):
        """Remote leg with the direct + op-id headers; protobuf wire
        encoded lazily on the first remote owner, JSON fallback for
        inputs the codec refuses (mirrors the query-path forwarding)."""
        cache: list = []

        def forward(client):
            from pilosa_tpu_torch.api import proto
            if not cache:
                try:
                    cache.append((encode(), True))
                except ValueError:
                    cache.append((None, False))
            body, is_proto = cache[0]
            headers = {"X-Pilosa-Direct": "1", "X-Pilosa-Op-Id": op_id}
            if is_proto:
                return client._do("POST", path, body,
                                  content_type=proto.CONTENT_TYPE,
                                  headers=headers)["changed"]
            return client._json("POST", path, json_body(),
                                headers=headers)["changed"]
        return forward

    def _hint_record(self, index: str, field: str, shard: int,
                     op_name: str, op_id: str, payload: dict) -> dict:
        """A replayable bulk hint: same routing facts the AAE gating
        and drain machinery key on as PQL hints, plus the import
        payload."""
        return {"id": op_id, "index": index, "op": op_name,
                "field": field, "shards": [int(shard)],
                "kind": "import", "import": payload}

    def _hint(self, peer: str, record: dict) -> None:
        hints = self.cluster.hints
        hints.add(peer, record)
        self.cluster.stats.count("hint_handoff_total", 1, peer=peer)
        self.cluster.logger.info(
            "%s batch hinted for %s (replica down)", record["op"], peer)

    def _shard_op(self, index: str, field: str, shard: int, *,
                  op_name: str, op_id: str, additive: bool,
                  apply_local, forward, hint_payload: dict) -> int:
        """Apply one shard batch on every replica owner through the
        breaker-aware split; returns the first successful owner's
        changed count."""
        from pilosa_tpu_torch.api.client import ClientError
        cluster = self.cluster
        dist = cluster.dist
        owners = cluster.shard_owners(index, shard)
        hints = cluster.hints
        record = self._hint_record(index, field, shard, op_name, op_id,
                                   hint_payload)
        if hints is None:
            # handoff disabled: the legacy contract — additive imports
            # are best-effort over reachable owners (AAE repairs on
            # rejoin), clearing imports fail-fast BEFORE any replica
            # applies
            reachable = dist._write_reachable()
            dead = sorted(set(owners) - reachable)
            if dead and not additive:
                raise dist._unavailable(op_name, dead[0], "replica_down")
            targets, handed = [o for o in owners if o in reachable], []
            if not targets:
                raise dist._unavailable(op_name, dead[0] if dead
                                        else None, "no_live_replica")
            if dead:
                cluster.stats.count("write_replicas_missed", len(dead))
        else:
            targets, handed = dist._split_write_targets(
                op_name, owners, additive=additive)
            for peer in handed:
                # hint FIRST (durable intent), then apply live — a
                # coordinator crash in between re-delivers, never loses
                self._hint(peer, record)

        def one(node_id):
            if node_id == cluster.node_id:
                return apply_local()
            return forward(cluster._client(node_id))

        def guarded(node_id):
            try:
                return ("ok", one(node_id))
            except ClientError as e:
                # the ONE shared classification with the PQL write
                # path: down / busy / propagate ("state unknown")
                tag = dist.write_failure_class(e)
                if tag is None:
                    raise
                return (tag, (node_id, e))

        if len(targets) == 1:
            outs = [guarded(targets[0])]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=len(targets)) as pool:
                outs = list(pool.map(guarded, targets))
        oks = [r for tag, r in outs if tag == "ok"]
        downs = [r for tag, r in outs if tag == "down"]
        busys = [r for tag, r in outs if tag == "busy"]
        if downs and hints is not None:
            for nid, _err in downs:
                self._hint(nid, record)
            downs = []
        if busys and not additive:
            nid, _err = busys[0]
            raise dist._unavailable(op_name, nid, "replica_busy")
        downs += busys
        if downs and (not additive or not oks):
            from pilosa_tpu_torch.exec.executor import ExecutionError
            nid, err = downs[0]
            raise ExecutionError(
                f"replica {nid} unreachable for {op_name}: {err}")
        if not oks:
            # every live target died mid-apply (each hinted): nothing
            # applied NOW — acking would claim otherwise; the hints
            # stay queued and replay un-acked (at-least-once)
            raise dist._unavailable(op_name, targets[0],
                                    "no_live_replica")
        if downs:
            cluster.stats.count("write_replicas_missed", len(downs))
            cluster.logger.warning(
                "%s batch applied on %d/%d owners; missed %s",
                op_name, len(oks), len(targets),
                [nid for nid, _ in downs])
        return int(oks[0])
