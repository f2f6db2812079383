"""Node-to-node internal HTTP handlers (``pilosa_tpu.cluster.internal``'s).

Reference: the ``/internal/*`` surface of ``http/handler.go`` —
query fan-out, fragment block/data exchange for AAE + resize, translate
streaming, cluster messages (SURVEY.md §3.3).  :func:`register_internal_
routes` adds them to the REST server's routes; every handler 503s when
the node is not clustered.  A handler is a function of the request's
:class:`~pilosa_tpu_torch.api.server.Handler`.

**Idempotency contract**: every POST endpoint on this surface MUST be
idempotent.  The cluster layer's internode :class:`~pilosa_tpu_torch.api
.client.Client` is constructed with ``idempotent_posts=True``, which
re-sends a request whose response was lost after the peer may already
have processed it (stale keep-alive socket, connection reset) —
at-least-once delivery.  The current endpoints all qualify: fragment
``merge`` is a union (∪ is idempotent), translate ``replicate`` dedupes
by log offset, ``heartbeat``/``status``/``schema`` apply last-writer
state merges, ``resize/push`` re-streams a union-merge, and
``hints/replay`` dedupes by unique op id against a durable window
(the request-ID pattern).  A future
non-idempotent endpoint must NOT ride this client — give it a dedicated
``Client()`` (default: no retry after a possibly-delivered request) or
add request IDs."""

from __future__ import annotations

from typing import TYPE_CHECKING

from pilosa_tpu_torch.api.api import ApiError
from pilosa_tpu_torch.store import roaring

if TYPE_CHECKING:
    from pilosa_tpu_torch.api.server import Handler


def _cluster(handler: Handler):
    cluster = handler.server.api.cluster
    if cluster is None:
        raise ApiError("node is not clustered", 503)
    return cluster


def _qs(handler: Handler, name: str) -> str:
    vals = handler.query.get(name)
    if not vals:
        raise ApiError(f"missing query param {name!r}")
    return vals[0]


def _fragment(handler: Handler, create: bool = False):
    api = handler.server.api
    idx = api.holder.index(_qs(handler, "index"))
    if idx is None:
        raise ApiError("index not found", 404)
    field = idx.field(_qs(handler, "field"))
    if field is None:
        raise ApiError("field not found", 404)
    view = field.view(_qs(handler, "view"), create=create)
    if view is None:
        raise ApiError("view not found", 404)
    frag = view.fragment(int(_qs(handler, "shard")), create=create)
    if frag is None:
        raise ApiError("fragment not found", 404)
    return frag


# -- handlers ----------------------------------------------------------------


def h_join(self: Handler) -> None:
    self._reply(_cluster(self).handle_join(self._json_body()))


def h_heartbeat(self: Handler) -> None:
    b = self._json_body()
    self._reply(_cluster(self).handle_heartbeat(
        b["id"], b.get("state", "NORMAL"),
        float(b.get("placementVersion", 0.0)),
        hints_for=b.get("hintsFor")))


def h_cluster_state(self: Handler) -> None:
    """Full cluster-state snapshot (pull-on-mismatch convergence for
    peers whose placement version trails the sender's)."""
    self._reply(_cluster(self).status_payload())


def h_cluster_status(self: Handler) -> None:
    _cluster(self).handle_status(self._json_body())
    self._reply({"success": True})


def h_internal_query(self: Handler) -> None:
    """Execute locally only (no re-fan-out) with raw-ID results —
    reference: ``/internal/query`` remote execution.

    Cross-node span fan-in: a ``Traceparent`` header opens a
    node-tagged continuation span around the local execution, and the
    finished subtree rides back in the response as ``profile`` — the
    coordinator grafts it under its ``cluster.*`` span, so one profile
    tree covers every node.  Requests without the header pay nothing."""
    from pilosa_tpu_torch.exec import result_to_json
    from pilosa_tpu_torch.exec.errors import (ExecutionError,
                                              PipelineStalledError,
                                              QueryTimeoutError,
                                              WriteUnavailableError)
    from pilosa_tpu_torch.exec.executor import ExecutorSaturatedError
    from pilosa_tpu_torch.pql.parser import ParseError
    import time

    api = self.server.api
    index = _qs(self, "index")
    shards = None
    if "shards" in self.query:
        shards = [int(s) for s in self.query["shards"][0].split(",") if s]
    deadline = None
    budget = None
    if "timeout" in self.query:
        # remaining budget shipped by the coordinator, re-anchored on
        # THIS node's monotonic clock.  Validated exactly like the
        # public ?timeout= — this endpoint is reachable by
        # any peer.
        from pilosa_tpu_torch.api.server import parse_timeout_param
        budget = parse_timeout_param(self.query["timeout"][0])
        deadline = time.monotonic() + budget
    t0 = time.monotonic()
    # storage quarantine gate: a leg covering a shard whose
    # local fragment is quarantined must not serve (possibly corrupt)
    # bits — 503 here is transport-class to the coordinator's fan-out,
    # which re-groups the shards onto the next live replica (the
    # failover path, exactly as if the shard were remote)
    sh = getattr(api.holder, "storage_health", None)
    if sh is not None and sh.gate_active:
        bad = [s for s in (shards or ())
               if sh.shard_quarantined(index, s)]
        if not shards and any(
                e.get("key") and e["key"][0] == index
                for e in sh.quarantined_entries()):
            bad = ["*"]
        if bad:
            raise ApiError(
                f"shard(s) {bad} of {index!r} quarantined on this "
                "node (storage corruption): retry a replica", 503,
                retry_after=2.0)
    pql = self._body().decode()
    from contextlib import nullcontext

    tracer = span = None
    retain = False
    parsed = None
    tp = self.headers.get("Traceparent")
    if tp:
        from pilosa_tpu_torch.obs import parse_traceparent
        parsed = parse_traceparent(tp)
    if parsed is not None and parsed[2] in ("01", "02"):
        from pilosa_tpu_torch.obs import Tracer
        # the coordinator materializes this trace: build the
        # node-tagged subtree, ship it back for grafting.  "01"
        # (sampled/profiled) also keeps a copy in THIS node's ring;
        # "02" (slow-hunt) ships the subtree — a slow capture needs
        # it — WITHOUT churning the local 128-slot ring for every
        # query at serving rate
        tracer = Tracer()
        retain = parsed[2] == "01"
    exec_tracer = tracer
    if tracer is None and parsed is not None:
        # flags "00" = the coordinator runs the LITE path and will
        # never materialize a tree — building one here would be pure
        # per-request waste on every fan-out leg; serve under the
        # allocation-free tracer
        from pilosa_tpu_torch.obs import NULL_TRACER
        exec_tracer = NULL_TRACER
    node = (api.cluster.node_id if api.cluster is not None else "local")
    ctx = (tracer.extract(self.headers, "internal.query",
                          node=node, index=index)
           if tracer is not None else nullcontext())
    # propagated legs carry the coordinator's trace id in the header
    # (flags "00" included — the lite path propagates identity): make
    # it this thread's ACTIVE id so the peer's log lines join the same
    # trace as the coordinator's exemplar and span tree
    from pilosa_tpu_torch.obs.tracing import set_current_trace_id
    set_current_trace_id(parsed[0] if parsed is not None else None)
    try:
        with ctx as span:
            results = api.executor.execute(index, pql, shards=shards,
                                           translate_output=False,
                                           deadline=deadline,
                                           tracer=exec_tracer)
    except QueryTimeoutError as e:
        # same structured 504 as the public edge: the coordinator maps
        # it back to QueryTimeoutError, and an operator curling a node
        # directly sees elapsed-vs-budget
        raise ApiError.timeout(e, time.monotonic() - t0, budget)
    except PipelineStalledError as e:
        # same structured 500 as the public edge: a quarantined
        # dispatch-pipeline window on THIS node names the stalled
        # stage — the coordinator's fan-out sees a server fault, not a
        # bad query, and an operator curling the peer sees the stage
        raise ApiError.pipeline_stall(e)
    except ExecutorSaturatedError as e:
        # a saturated PEER is overload, not a bad query: 503 so the
        # coordinator's fan-out classifies it like a busy node (and a
        # best-effort write may route around it), never 400
        raise ApiError(str(e), 503, retry_after=e.retry_after)
    except WriteUnavailableError as e:
        # same structured 503 as the public edge: a replica-down
        # refusal names the down replica and why handoff could not
        # cover it — unavailability, never a generic 400
        raise ApiError.write_unavailable(e)
    except (ParseError, ExecutionError) as e:
        raise ApiError(str(e), 400)
    finally:
        # handler threads serve keep-alive connections: a stale id
        # must not bleed into the next request's log lines
        set_current_trace_id(None)
    out = {"results": [result_to_json(r) for r in results]}
    if span is not None:
        # ship the finished subtree back for coordinator-side grafting
        out["profile"] = [span.to_json()]
        if retain:
            from pilosa_tpu_torch.obs import GLOBAL_TRACER
            GLOBAL_TRACER.record(span)
    self._reply(out)


def h_shards(self: Handler) -> None:
    idx = self.server.api.holder.index(_qs(self, "index"))
    self._reply({"shards": idx.available_shards() if idx else []})


def h_fragments(self: Handler) -> None:
    self._reply({"fragments": _cluster(self)._local_inventory()})


def h_schema_apply(self: Handler) -> None:
    schema = self._json_body()["schema"]
    cluster = self.server.api.cluster
    if cluster is not None:
        schema = cluster.filter_schema(schema)
    self.server.api.apply_schema(schema)
    self._reply({"success": True})


def h_schema_delete(self: Handler) -> None:
    b = self._json_body()
    api = self.server.api
    if api.cluster is not None:
        api.cluster.record_schema_tombstone(b["index"], b.get("field"),
                                            b.get("ts", 0.0))
    try:
        if b.get("field"):
            api.delete_field(b["index"], b["field"], direct=True)
        else:
            api.delete_index(b["index"], direct=True)
    except ApiError as e:
        if e.status != 404:  # already gone on this node is fine
            raise
    self._reply({"success": True})


def h_translate(self: Handler) -> None:
    b = self._json_body()
    try:
        ids = _cluster(self).handle_translate(
            b["index"], b.get("field"), b["keys"], b.get("create", False))
    except PermissionError as e:
        raise ApiError(str(e), 409)
    self._reply({"ids": ids})


def h_translate_replicate(self: Handler) -> None:
    b = self._json_body()
    cluster = _cluster(self)
    log = (cluster.api.executor.translate.columns(b["index"])
           if b.get("field") is None
           else cluster.api.executor.translate.rows(b["index"], b["field"]))
    try:
        log.append_replicated(b["start_id"], b["keys"])
    except KeyError as e:
        raise ApiError(str(e), 409)
    self._reply({"len": len(log)})


def _translate_log(self: Handler):
    api = self.server.api
    index = _qs(self, "index")
    field = self.query.get("field", [""])[0] or None
    return (api.executor.translate.columns(index) if field is None
            else api.executor.translate.rows(index, field))


def h_translate_tail(self: Handler) -> None:
    log = _translate_log(self)
    after = int(self.query.get("after", ["0"])[0])
    limit = self.query.get("limit", [None])[0]
    limit = int(limit) if limit else None
    self._reply({"keys": log.tail(after, limit=limit), "len": len(log)})


def h_translate_len(self: Handler) -> None:
    self._reply({"len": len(_translate_log(self))})


def h_translate_logs(self: Handler) -> None:
    stores = self.server.api.executor.translate.list_stores()
    self._reply({"logs": [{"index": i, "field": f} for i, f in stores]})


def h_hints_replay(self: Handler) -> None:
    """Drain-side receive path for durable hinted handoff: apply
    a batch of hinted ops IN ORDER, deduping by unique op id against
    the node's durable :class:`~pilosa_tpu_torch.store.oplog.IdWindow` —
    re-delivered batches (lost response, sender crash mid-ack) are
    no-ops, so the at-least-once internode retry is safe here.

    A hint that can no longer apply (index/field deleted since it was
    queued) is DROPPED with a warning rather than wedging the sender's
    drain forever — but only once this node's boot-time schema pull
    has settled (``Cluster.schema_settled``): a drain kicked by our
    own join request can arrive BEFORE the join response's
    ``apply_schema`` lands, and judging "deleted" then would
    permanently lose an acked write for an index created while this
    node was down.  A not-yet-settled miss (and a saturated executor)
    answers 503 so the sender retries the whole batch later (the
    applied prefix dedups)."""
    from pilosa_tpu_torch.exec.errors import ExecutionError
    from pilosa_tpu_torch.exec.executor import ExecutorSaturatedError
    from pilosa_tpu_torch.pql.parser import ParseError
    from pilosa_tpu_torch.store.health import StorageFaultError

    cluster = _cluster(self)
    api = self.server.api
    applied = deduped = dropped = 0
    for op in self._json_body().get("ops", []):
        op_id = str(op.get("id", ""))
        if not op_id:
            raise ApiError("hint op missing id")
        if op_id in cluster.applied_ops:
            deduped += 1
            continue
        fld = op.get("field")
        fld = str(fld) if fld is not None else None
        idx_obj = api.holder.index(op["index"])
        if ((idx_obj is None
             or (fld is not None and idx_obj.field(fld) is None))
                and not cluster.schema_settled(op["index"], fld)):
            raise ApiError(
                f"hint replay deferred: index {op['index']!r}"
                + (f" field {fld!r}" if fld is not None else "")
                + " not known here yet (schema pull pending)",
                503, retry_after=1.0)
        shards = op.get("shards")
        try:
            if op.get("kind") == "import":
                # bulk-import hint: apply the batch payload
                # straight into fragments — same dedup/order contract
                # as PQL hints, no PQL round trip.  Un-applyable
                # payloads (field gone → 404, malformed roaring/ids)
                # reclassify as ExecutionError so ONLY this leg takes
                # the drop path — PQL replay errors keep their earlier
                # classes (an unexpected ValueError there must stay a
                # retryable 500, not a permanent applied-marked drop)
                from pilosa_tpu_torch.ingest import apply_import_hint
                try:
                    apply_import_hint(api, op)
                except ApiError as e:
                    if e.status == 503:
                        raise  # deferred: sender retries the batch
                    raise ExecutionError(str(e)) from e
                except (ValueError, KeyError) as e:
                    raise ExecutionError(str(e)) from e
            else:
                api.executor.execute(
                    op["index"], op["pql"],
                    shards=([int(s) for s in shards] if shards else None),
                    translate_output=False)
        except ExecutorSaturatedError as e:
            raise ApiError(str(e), 503, retry_after=e.retry_after)
        except StorageFaultError as e:
            # this node's storage is sick (read-only on disk-full, or
            # the target fragment quarantined): the op is
            # RETRYABLE, never droppable — defer the whole batch (the
            # applied prefix dedups on the retry)
            raise ApiError.storage_fault(e)
        except (ParseError, ExecutionError) as e:
            cluster.logger.warning(
                "hint replay dropped %s on %s: %s",
                op.get("op", "?"), op.get("index", "?"), e)
            dropped += 1
            cluster.stats.count("hint_replay_dropped_total", 1)
            cluster.applied_ops.add(op_id)
            continue
        cluster.applied_ops.add(op_id)
        applied += 1
    self._reply({"applied": applied, "deduped": deduped,
                 "dropped": dropped})


def _check_fragment_health(handler: Handler, frag) -> None:
    """AAE exchange gate: a quarantined fragment's bytes are
    untrustworthy — serving its blocks/data would spread the
    corruption to replicas.  503 defers the peer's sync until repair
    un-quarantines (the repair itself pulls FROM the healthy peer, so
    this gate never deadlocks a repair)."""
    sh = getattr(handler.server.api.holder, "storage_health", None)
    if sh is not None and sh.is_quarantined(frag.path):
        raise ApiError(
            f"fragment quarantined (storage corruption): {frag.path} "
            "— sync deferred until replica repair completes", 503,
            retry_after=2.0)


def h_fragment_blocks(self: Handler) -> None:
    cluster = self.server.api.cluster
    if cluster is not None and cluster.node_id in cluster.hinted_peers():
        # this node has hinted writes pending somewhere: its copies
        # are stale until the replay lands — a peer diffing against
        # them now could union a cleared bit back in.  409 defers the
        # sync (the peer retries after the drain).
        raise ApiError("fragment blocks deferred: hinted writes "
                       "pending for this node (replay first)", 409)
    frag = _fragment(self)
    _check_fragment_health(self, frag)
    self._reply({"blocks": {str(k): v for k, v in frag.blocks().items()}})


def h_fragment_data(self: Handler) -> None:
    frag = _fragment(self)
    _check_fragment_health(self, frag)
    if "block" in self.query:
        positions = frag.block_positions(int(_qs(self, "block")))
    else:
        positions = frag.positions()
    self._reply(roaring.serialize(positions),
                content_type="application/octet-stream")


def h_fragment_merge(self: Handler) -> None:
    cluster = self.server.api.cluster
    if (cluster is not None and cluster.hints is not None
            and cluster.hints.gated_fragment(
                _qs(self, "index"), _qs(self, "field"),
                int(_qs(self, "shard")))):
        # this node coordinated writes still hinted for a down peer
        # covering this fragment: a union-merge in could resurrect a
        # Clear the replay is about to deliver — defer until drained
        raise ApiError("fragment merge deferred: pending hinted "
                       "writes cover it (retry after drain)", 409)
    frag = _fragment(self, create=True)
    body = self._body()
    changed = frag.merge_positions(roaring.deserialize(body))
    stats = getattr(self.server, "stats", None)
    if stats is not None and self.headers.get("X-Pilosa-Restore") == "1":
        # restore pushes ride this union-merge path; tag their volume
        # separately from AAE repair traffic
        stats.count("restore_bytes_total", len(body))
    self._reply({"changed": changed})


def h_aae_run(self: Handler) -> None:
    """Force one anti-entropy round NOW (restore's convergence step —
    replicas a push missed must not wait out the periodic sweep).
    ``?index=&field=&view=&shard=``, each optional, limit the round to
    the fragments they name."""
    q = self.query
    scope = tuple(q[k][0] if q.get(k, [""])[0] else None
                  for k in ("index", "field", "view", "shard"))
    if scope[3] is not None:
        try:
            scope = scope[:3] + (int(scope[3]),)
        except ValueError:
            raise ApiError(f"bad shard param {scope[3]!r}")
    self._reply({"repaired": _cluster(self).sync_once(
        scope if any(w is not None for w in scope) else None)})


def _attr_store(self: Handler):
    api = self.server.api
    idx = api.holder.index(_qs(self, "index"))
    if idx is None:
        raise ApiError("index not found", 404)
    field = self.query.get("field", [""])[0]
    if field:
        f = idx.field(field)
        if f is None:
            raise ApiError("field not found", 404)
        return f.row_attrs
    return idx.column_attrs


def h_attr_blocks(self: Handler) -> None:
    store = _attr_store(self)
    self._reply({"blocks": {str(k): v for k, v in store.blocks().items()}})


def h_attr_block(self: Handler) -> None:
    store = _attr_store(self)
    items = store.block_items(int(_qs(self, "block")))
    self._reply({"items": {str(k): v for k, v in items.items()}})


def h_attr_merge(self: Handler) -> None:
    store = _attr_store(self)
    items = {int(k): v for k, v in self._json_body()["items"].items()}
    self._reply({"changed": store.merge_items(items)})


def h_resize_push(self: Handler) -> None:
    b = self._json_body()
    _cluster(self).push_fragment(b["index"], b["field"], b["view"],
                                 b["shard"], b["dest"])
    self._reply({"success": True})


def h_resize_trigger(self: Handler) -> None:
    cluster = _cluster(self)
    if not cluster.is_coordinator():
        raise ApiError("not the coordinator", 409)
    cluster.trigger_resize()
    self._reply({"success": True})


def h_resize_abort(self: Handler) -> None:
    """Abort an in-flight rebalance (reference: ResizeJob abort)."""
    cluster = _cluster(self)
    if not cluster.is_coordinator():
        raise ApiError("not the coordinator", 409)
    cluster.abort_resize()
    self._reply({"success": True})


def h_node_remove_internal(self: Handler) -> None:
    _cluster(self).handle_node_remove(self._json_body())
    self._reply({"success": True})


def h_node_remove(self: Handler, node: str) -> None:
    """Operator surface: remove a (dead or retiring) node.  Must be sent
    to the coordinator (reference: coordinator-driven remove-node
    resize)."""
    cluster = _cluster(self)
    try:
        cluster.remove_node(node)
    except PermissionError as e:
        raise ApiError(str(e), 409)
    except KeyError:
        raise ApiError(f"node {node!r} not in cluster", 404)
    except ValueError as e:
        raise ApiError(str(e), 400)
    self._reply({"success": True})


def register_internal_routes(routes: list) -> None:
    """Append the node-to-node routes to ``routes`` (the REST server's
    ``(method, compiled pattern, handler)`` list; a ``{name}`` segment
    matches one path segment)."""
    from pilosa_tpu_torch.api.server import _route
    for method, pattern, fn in (
            ("POST", "/internal/join", h_join),
            ("POST", "/internal/heartbeat", h_heartbeat),
            ("POST", "/internal/cluster/status", h_cluster_status),
            ("GET", "/internal/cluster/state", h_cluster_state),
            ("POST", "/internal/query", h_internal_query),
            ("GET", "/internal/shards", h_shards),
            ("GET", "/internal/fragments", h_fragments),
            ("POST", "/internal/schema", h_schema_apply),
            ("POST", "/internal/schema/delete", h_schema_delete),
            ("POST", "/internal/translate", h_translate),
            ("POST", "/internal/translate/replicate", h_translate_replicate),
            ("GET", "/internal/translate/tail", h_translate_tail),
            ("GET", "/internal/translate/len", h_translate_len),
            ("GET", "/internal/translate/logs", h_translate_logs),
            ("GET", "/internal/fragment/blocks", h_fragment_blocks),
            ("GET", "/internal/fragment/data", h_fragment_data),
            ("POST", "/internal/fragment/merge", h_fragment_merge),
            ("POST", "/internal/hints/replay", h_hints_replay),
            ("POST", "/internal/aae/run", h_aae_run),
            ("POST", "/internal/resize/push", h_resize_push),
            ("POST", "/internal/resize/trigger", h_resize_trigger),
            ("POST", "/internal/resize/abort", h_resize_abort),
            ("GET", "/internal/attrs/blocks", h_attr_blocks),
            ("GET", "/internal/attrs/block", h_attr_block),
            ("POST", "/internal/attrs/merge", h_attr_merge),
            ("POST", "/internal/node/remove", h_node_remove_internal),
            ("DELETE", "/cluster/node/{node}", h_node_remove),
    ):
        routes.append(_route(method, pattern, fn))
