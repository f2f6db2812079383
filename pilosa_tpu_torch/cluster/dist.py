"""Distributed query execution: fan-out over nodes, merge partials
(``pilosa_tpu.cluster.dist``'s).

Reference: ``executor.go#mapReduce`` (SURVEY.md §4.2) — shards are
grouped by owning node; local shards execute through this node's
executor on its card, remote groups ship the sub-query as PQL text to
``POST /internal/query`` on the peer (the rebuild of
``InternalClient.QueryNode``), and partial results merge host-side.
Intra-node merging stays on the card; only the per-node partials
(already tiny: counts, id lists, pairs) merge here.

Key translation in cluster mode happens at the edge (this module):
inputs are translated before routing (so shard targets are known) via
the partition-owner nodes, outputs after merging — local executors run
with ``translate_output=False``.
"""

from __future__ import annotations

import os

import numpy as np

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.exec import result_to_json
from pilosa_tpu_torch.exec.executor import ExecutionError, WriteUnavailableError
from pilosa_tpu_torch.pql import parse_cached
from pilosa_tpu_torch.pql.ast import Call, Condition, Query

WRITE_CALLS = frozenset({"Set", "Clear", "ClearRow", "Store"})
# attrs are replicated everywhere (not sharded): broadcast writes
ATTR_CALLS = frozenset({"SetRowAttrs", "SetColumnAttrs"})

_MAX_U64 = (1 << 64) - 1


def _call_of(call: Call) -> Call:
    """Unwrap Options() to the effective call."""
    return call.children[0] if call.name == "Options" and call.children else call


def _transport_class(e: BaseException):
    """The transport-class failure behind a failed READ leg — the class
    that is safe and useful to retry on a replica — or None when the
    failure is fatal no matter which node answers: query errors (400),
    deadline expiry (``QueryTimeoutError`` — the budget is gone on
    every replica), and other HTTP statuses.  Counted as transport:

    - ``ClientError`` kinds ``unreachable``/``transport``/``timeout``
      (dead peer, connect refused/reset/timed out, TLS alert; a
      post-send timeout is retryable for READS because the internode
      query surface is idempotent by contract) — raw, or as the
      ``__cause__`` of ``internal_query``'s ``ExecutionError`` mapping;
    - a peer 503 (saturated or not-yet-clustered: route around it, as
      ``h_internal_query``'s shedding contract intends);
    - ``fault.FaultError`` (the ``dist.fanout`` ``error`` action — it
      stands in for a leg dying mid-flight).
    """
    from pilosa_tpu_torch.api.client import ClientError
    from pilosa_tpu_torch.exec.executor import QueryTimeoutError
    if isinstance(e, QueryTimeoutError):
        return None
    if isinstance(e, fault.FaultError):
        return e
    c = e if isinstance(e, ClientError) else None
    if c is None and isinstance(e, ExecutionError) \
            and isinstance(e.__cause__, ClientError):
        c = e.__cause__
    if c is None:
        return None
    if c.status == 503 or c.kind != "http":
        return c
    return None


def _nested_limit(call: Call, top: bool = True) -> bool:
    eff = _call_of(call) if top else call
    if eff.name == "Limit" and not top:
        return True
    if any(_nested_limit(c, False) for c in eff.children):
        return True
    return any(isinstance(v, Call) and _nested_limit(v, False)
               for v in eff.args.values())


def _strip_truncation(call: Call) -> Call:
    """Remove per-node truncation args (TopN n, Rows/GroupBy limit) from
    the fan-out sub-query — each node must return full partials or the
    merge is inexact (the reference needs a second query phase for the
    same reason, ``executeTopN`` SURVEY.md §4.3; here nodes return full
    count vectors instead)."""
    eff = _call_of(call)
    # GroupBy having= also strips: per-node partial counts/sums cannot
    # be thresholded locally; the filter applies to the global sums in
    # merge_results
    strip = {"TopN": ("n",), "Rows": ("limit",),
             "GroupBy": ("limit", "having"),
             "All": ("limit", "offset"), "Limit": ("limit", "offset")}
    keys = strip.get(eff.name) or ()
    extra = {}
    if eff.name == "TopN" and "tanimoto" in eff.args:
        # tanimoto is a RATIO: per-node thresholds don't merge.  Nodes
        # return intersection+row counts and |src| (``_rowCounts=1``);
        # the threshold applies on the global sums in merge_results.
        # Validate here — nodes never see the stripped arg, so the
        # single-node executor's range check would not run.
        thr = float(eff.args["tanimoto"])
        if not 0 < thr <= 100:
            raise ExecutionError("TopN: tanimoto must be in (0, 100]")
        keys = keys + ("tanimoto",)
        extra["_rowCounts"] = 1
    if extra or (keys and any(k in eff.args for k in keys)):
        eff = Call(eff.name,
                   {**{k: v for k, v in eff.args.items() if k not in keys},
                    **extra},
                   eff.children)
    if call.name == "Options":
        # the shards list was already resolved into per-node groups;
        # forwarding it would make each node re-apply the FULL list
        # over its replicas and additive merges would over-count
        args = {k: v for k, v in call.args.items() if k != "shards"}
        return Call("Options", args, [eff])
    return eff


class DistributedExecutor:
    """Same surface as :class:`pilosa_tpu_torch.exec.Executor`.execute but
    JSON-valued, routing shards across the cluster."""

    def __init__(self, cluster):
        self.cluster = cluster  # Cluster (membership + clients + api)
        # the active request's tracer, visible to every nested _read /
        # _fanout_partials on this thread (the public surface threads
        # tracer only into execute_json)
        import threading
        self._tls = threading.local()

    # -- public -------------------------------------------------------------

    def execute_json(self, index: str, pql: str,
                     shards: list[int] | None = None, tracer=None,
                     deadline: float | None = None) -> list:
        """``deadline`` is checked between top-level calls, honored by
        the local partial execution inside each fan-out, and shipped to
        remote nodes as their remaining budget (re-anchored on the
        peer's monotonic clock; a peer's expiry comes back as 504 and
        re-raises as QueryTimeoutError here)."""
        import time as _time

        from contextlib import nullcontext

        from pilosa_tpu_torch.exec.executor import QueryTimeoutError
        from pilosa_tpu_torch.obs import LiteTracer
        query = parse_cached(pql)
        out = []
        calls = query.calls
        self._tls.tracer = tracer
        # lite-path queries build no spans, but a slow capture still
        # needs per-call attribution: record plain (name, seconds)
        # marks on the LiteTracer — the traced path gets the same data
        # from its cluster.* spans, so marking there would double it
        lite = isinstance(tracer, LiteTracer)
        try:
            i = 0
            while i < len(calls):
                if deadline is not None and _time.monotonic() > deadline:
                    raise QueryTimeoutError("query timeout exceeded")
                t_call = _time.perf_counter() if lite else 0.0
                call = calls[i]
                name = _call_of(call).name
                # consecutive plain reads fan out as ONE multi-call
                # query per node — a 32-Count batch costs (nodes-1)
                # RPCs, not 32*(nodes-1) (reference: executor.go runs
                # the whole query per shard in one mapReduce)
                if self._batchable(call):
                    j = i
                    while j < len(calls) and self._batchable(calls[j]):
                        j += 1
                    batch = calls[i:j]
                    span = (nullcontext() if tracer is None
                            else tracer.span(
                                f"cluster.batch[{len(batch)}]",
                                index=index)
                            if len(batch) > 1
                            else tracer.span("cluster." + name,
                                             index=index))
                    with span:
                        if len(batch) == 1:
                            out.append(self._read(index, call, shards,
                                                  deadline=deadline))
                        else:
                            out.extend(self._read_group(
                                index, batch, shards, deadline=deadline))
                    if lite:
                        # mirror the traced path's span naming: a
                        # single-call batch is "cluster.<name>"
                        tracer.stage(
                            f"cluster.batch[{len(batch)}]"
                            if len(batch) > 1 else "cluster." + name,
                            _time.perf_counter() - t_call)
                    i = j
                    continue
                span = (tracer.span("cluster." + name, index=index)
                        if tracer is not None else nullcontext())
                with span:
                    if name in ATTR_CALLS:
                        out.append(self._attr_write(index, call))
                    elif name in WRITE_CALLS:
                        out.append(self._write(index, call))
                    elif name == "Percentile":
                        out.append(self._percentile(index, call, shards,
                                                    deadline=deadline))
                    else:
                        out.append(self._read(index, call, shards,
                                              deadline=deadline))
                if lite:
                    tracer.stage("cluster." + name,
                                 _time.perf_counter() - t_call)
                i += 1
        finally:
            self._tls.tracer = None
        return out

    @staticmethod
    def _batchable(call: Call) -> bool:
        """Reads with no shard override and no nested Limit share one
        fan-out; everything else keeps its own dispatch (writes for
        ordering, Options(shards)/nested-Limit for their rewrites)."""
        name = _call_of(call).name
        return (name not in WRITE_CALLS and name not in ATTR_CALLS
                and name != "Percentile" and call.name != "Options"
                and not _nested_limit(call))

    def _read_group(self, index: str, calls: list[Call],
                    shards: list[int] | None,
                    deadline: float | None = None) -> list:
        """Fan out several independent read calls as one query per node
        and merge each call's partials (the general-call sibling of
        ``_read_many``; local execution also engages the executor's
        whole-query count/aggregate fusion)."""
        calls = [self._translate_input(index, c) for c in calls]
        subs = [_strip_truncation(c) for c in calls]
        per_node = self._fanout_partials(index, subs, shards,
                                         deadline=deadline)
        out = []
        for k, call in enumerate(calls):
            eff = _call_of(call)
            merged = merge_results(eff, [pn[k] for pn in per_node])
            out.append(self._translate_output(index, eff, merged))
        return out

    # k-ary search fan-out width: one round ships K Counts per node in
    # ONE multi-call query (nodes fuse consecutive Counts into a single
    # program + read), so rounds = log_{K+1}(value range) instead of
    # log_2 — a 21-bit field resolves in ~6 fan-outs, not ~42
    PERCENTILE_FANOUT = 16

    def _percentile(self, index: str, call: Call, shards,
                    deadline: float | None = None):
        """Percentile cannot merge from per-node partials (a median of
        medians is not a median): run a k-ary search HERE with
        cluster-wide counts — each round one batched multi-Count
        fan-out over the normal query path."""
        import math
        # translate key inputs ONCE here — _read_many ships raw PQL to
        # peers without the per-call _read translation step
        call = self._translate_input(index, call)
        eff = _call_of(call)
        fname = eff.args.get("field") or eff.args.get("_field")
        nth = eff.args.get("nth")
        if fname is None or nth is None:
            raise ExecutionError("Percentile: field= and nth= required")
        nth = float(nth)
        if not 0 <= nth <= 100:
            raise ExecutionError("Percentile: nth must be in [0, 100]")
        idx = self.cluster.api.holder.index(index)
        field = idx.field(str(fname)) if idx else None
        if field is None:
            raise ExecutionError(f"field {fname!r} not found")
        base = field.options.base
        bound = (1 << field.options.bit_depth) - 1
        flt = eff.args.get("filter")
        children = [c for c in eff.children]

        def count_call(offset: int) -> Call:
            v = offset + base
            if field.options.type == "decimal":
                v = v / 10**field.options.scale
            row = Call("Row", {str(fname): Condition("<=", v)})
            tree = (Call("Intersect", {}, [row] + children +
                         ([flt] if isinstance(flt, Call) else []))
                    if (children or isinstance(flt, Call)) else row)
            return Call("Count", {}, [tree])

        def dist_counts(offsets: list[int]) -> list[int]:
            return self._read_many(index,
                                   [count_call(o) for o in offsets],
                                   shards, deadline=deadline)

        (total,) = dist_counts([bound])
        if total == 0:
            return {"value": 0, "count": 0}
        target = max(1, math.ceil(nth / 100.0 * total))
        k = self.PERCENTILE_FANOUT
        lo, hi = -bound, bound
        while lo < hi:
            if hi - lo <= k:
                cands = list(range(lo, hi))
            else:
                cands = sorted({lo + (hi - lo) * (j + 1) // (k + 1)
                                for j in range(k)})
            cnts = dist_counts(cands)
            prev = lo - 1
            nlo, nhi = None, hi
            for cand, c in zip(cands, cnts):
                if c >= target:
                    nlo, nhi = prev + 1, cand
                    break
                prev = cand
            if nlo is None:
                nlo = prev + 1
            lo, hi = nlo, nhi
        if lo > -bound:
            at, below = dist_counts([lo, lo - 1])
        else:
            (at,), below = dist_counts([lo]), 0
        return {"value": field.from_stored(lo + base), "count": at - below}

    def _fanout_partials(self, index: str, subs: list[Call], shards,
                         deadline: float | None = None) -> list[list]:
        """The one per-node fan-out: run ``subs`` locally over this
        node's shard group while peers execute the same multi-call
        query concurrently.  Returns one ``[per-call JSON partial]``
        list per participating node (the caller's merges are
        associative over disjoint shard sets, so a failed-over or
        hedged leg may legally come back as several entries).

        Availability — reads are idempotent by the internode
        contract, so a leg is never a single point of failure:

        - **replica failover**: a leg that dies with a transport-class
          error (:func:`_transport_class`) re-groups its shards by
          their next live replica — per shard, since replicas differ
          across partitions — and retries there, bounded by
          ``failover_max_depth`` hops and the query deadline.  Writes
          never take this path (``_write``/``_run_on`` keep their
          strict semantics).
        - **hedged requests**: when ``hedge_after`` > 0, a leg that
          exceeds it gets a duplicate issued to live replicas; the
          first complete answer wins and the loser is abandoned.  The
          winning subtree is grafted with a ``hedged`` trace tag.

        The pool is torn down on EVERY exit path with
        ``cancel_futures=True`` — failover and hedging multiply
        in-flight legs, and none may outlive the dispatch (queued legs
        are dropped; already-running stragglers finish into ignored
        futures and release their threads)."""
        import time as _time
        from concurrent.futures import (FIRST_COMPLETED,
                                        ThreadPoolExecutor, wait)

        from pilosa_tpu_torch.exec.executor import QueryTimeoutError

        try:
            all_shards = (tuple(shards) if shards is not None
                          else self.cluster.index_shards(index,
                                                         strict=True))
        except RuntimeError as e:
            # an incomplete universe would silently undercount
            raise ExecutionError(str(e)) from e
        groups = self.cluster.group_shards_by_node(index, all_shards)
        pql = "\n".join(str(s) for s in subs)
        # span fan-in: capture the dispatching thread's open cluster.*
        # span HERE — remote legs run on pool threads where the
        # tracer's thread-local stack is empty — inject it as the
        # Traceparent every leg carries, and graft each peer's returned
        # subtree under it (to_json renders dict children verbatim)
        tracer = getattr(self._tls, "tracer", None)
        parent = tracer.current_span() if tracer is not None else None
        trace_headers = None
        if tracer is not None:
            # a LiteTracer has no open span but still injects its
            # trace IDENTITY (flags "00"): peers neither invent fresh
            # root spans nor churn their rings for a tree the
            # coordinator will never materialize
            trace_headers = {}
            tracer.inject(trace_headers, span=parent,
                          sampled=getattr(tracer, "sampled", True))
            if not trace_headers:
                trace_headers = None

        def remote(node_id, node_shards, tags=None):
            if fault.ACTIVE:
                # per-leg failpoint: `error` fails ONE node's share of
                # the fan-out (a remote leg dying mid-query), `delay`
                # models a straggler node without touching its process
                fault.fire("dist.fanout", peer=node_id, index=index)
            tr = ({"headers": trace_headers, **(tags or {})}
                  if trace_headers is not None else None)
            results = self.cluster.internal_query(
                node_id, index, pql, node_shards, deadline=deadline,
                trace=tr, map_unreachable=False)
            return results, tr

        def run_local(node_shards):
            # the local group executes on the DISPATCHING thread,
            # inside the open cluster.* span — its executor spans nest
            # there (also the failover target when a dead peer's shards
            # re-group onto this node)
            rs = self.cluster.api.executor.execute(
                index, Query(list(subs)), shards=list(node_shards),
                translate_output=False, deadline=deadline,
                tracer=tracer)
            return [result_to_json(r) for r in rs]

        def graft(tr) -> None:
            # graft on the DISPATCHING thread only, from collected
            # futures: a straggler leg abandoned by an earlier leg's
            # raise (or by losing its hedge race) must never mutate a
            # span tree that may already be closed, retained, and
            # served (its thread only ever touches its own `tr` dict)
            if tr is None or parent is None:
                return
            for sub in tr.get("profile") or []:
                tags = sub.setdefault("tags", {})
                for flag in ("retried", "hedged", "failover"):
                    # redelivered / hedge-winner / failed-over legs are
                    # visible in the profile: traces never lie under
                    # failure
                    if tr.get(flag):
                        tags[flag] = True
                parent.children.append(sub)

        cfg = self.cluster.cfg
        hedge_after = float(getattr(cfg, "hedge_after", 0.0) or 0.0)
        max_depth = int(getattr(cfg, "failover_max_depth", 2))
        stats = self.cluster.stats
        remote_items = [(n, s) for n, s in groups.items()
                        if n != self.cluster.node_id]
        per_node: list[list] = []
        pool = None

        def new_slot(node_id, node_shards, tried, depth, tags=None):
            return {"node": node_id, "shards": tuple(node_shards),
                    "primary": pool.submit(remote, node_id,
                                           tuple(node_shards), tags),
                    "tried": set(tried) | {node_id},
                    "depth": depth, "start": _time.monotonic(),
                    "hedge": None, "hedge_ok": [], "hedge_dead": False,
                    "settled": False}

        def settle(slot):
            slot["settled"] = True
            slots.remove(slot)

        def failover(slot, failed_node, err):
            """Re-group a transport-failed leg's shards onto their next
            live replicas (which may include THIS node) and retry."""
            stats.count("read_failover_total", 1, peer=failed_node)
            if deadline is not None and _time.monotonic() > deadline:
                raise QueryTimeoutError(
                    "query timeout exceeded during read failover") \
                    from err
            if slot["depth"] + 1 > max_depth:
                raise ExecutionError(
                    f"node {failed_node} unreachable and read failover "
                    f"exhausted after {max_depth} hops: {err}") from err
            try:
                regroups = self.cluster.group_shards_by_node(
                    index, slot["shards"], exclude=slot["tried"])
            except RuntimeError as e2:
                raise ExecutionError(
                    f"node {failed_node} unreachable: {err} (and no "
                    f"live replica remains: {e2})") from err
            for n2, s2 in regroups.items():
                if n2 == self.cluster.node_id:
                    per_node.append(run_local(s2))
                else:
                    slots.append(new_slot(n2, s2, slot["tried"],
                                          slot["depth"] + 1,
                                          tags={"failover": True}))

        def fire_hedges(now):
            for slot in slots:
                if (slot["hedge"] is not None or slot["primary"] is None
                        or now - slot["start"] < hedge_after):
                    continue
                slot["hedge"] = {}  # marks "hedge attempted" even if 0
                try:
                    # exclude every node that already failed this leg
                    # (tried includes the straggler): a failover leg
                    # must not hedge back onto the node that just died
                    regroups = self.cluster.group_shards_by_node(
                        index, slot["shards"], exclude=slot["tried"])
                except RuntimeError:
                    continue  # no live replica to hedge to
                if self.cluster.node_id in regroups:
                    # a self-targeted part would run synchronously on
                    # the dispatch thread and block the loop — let the
                    # straggler stand (failover still covers death)
                    continue
                stats.count("read_hedged_total", 1, peer=slot["node"])
                slot["hedge"] = {
                    pool.submit(remote, n2, s2, {"hedged": True}): n2
                    for n2, s2 in regroups.items()}

        slots: list[dict] = []
        try:
            if remote_items:
                # headroom beyond the original legs: failover and hedge
                # legs must not deadlock behind abandoned stragglers
                pool = ThreadPoolExecutor(
                    max_workers=2 * len(remote_items) + 2)
                for n, s in remote_items:
                    slots.append(new_slot(n, s, set(), 0))
            if self.cluster.node_id in groups:
                per_node.append(run_local(groups[self.cluster.node_id]))
            while slots:
                now = _time.monotonic()
                if hedge_after > 0:
                    fire_hedges(now)
                timeout = None
                if hedge_after > 0:
                    unhedged = [s["start"] + hedge_after for s in slots
                                if s["hedge"] is None
                                and s["primary"] is not None]
                    if unhedged:
                        timeout = max(0.0, min(unhedged) - now)
                futs = {}
                for slot in slots:
                    if slot["primary"] is not None:
                        futs[slot["primary"]] = slot
                    for hf in (slot["hedge"] or {}):
                        futs[hf] = slot
                done, _ = wait(list(futs), timeout=timeout,
                               return_when=FIRST_COMPLETED)
                for f in done:
                    slot = futs[f]
                    if slot["settled"]:
                        continue  # twin answered earlier this pass
                    is_hedge = bool(slot["hedge"]) and f in slot["hedge"]
                    try:
                        results, tr = f.result()
                    except Exception as e:  # noqa: BLE001 — classified
                        te = _transport_class(e)
                        if te is None:
                            if isinstance(e, QueryTimeoutError):
                                e.shards_outstanding = sum(
                                    len(s["shards"]) for s in slots
                                    if not s["settled"])
                            raise
                        if is_hedge:
                            failed = slot["hedge"].pop(f)
                            slot["tried"].add(failed)
                            if slot["primary"] is None:
                                # the primary already died; the hedge
                                # was the leg — fail over for real
                                settle(slot)
                                failover(slot, failed, te)
                            else:
                                # primary still in flight; the hedge
                                # set can no longer complete
                                slot["hedge_dead"] = True
                            continue
                        if slot["hedge"] and not slot["hedge_dead"]:
                            # primary died but a live hedge set covers
                            # the shards — let it race on
                            slot["primary"] = None
                            continue
                        settle(slot)
                        failover(slot, slot["node"], te)
                        continue
                    if is_hedge:
                        # pop FIRST: a completed future left in the
                        # hedge map would re-trigger wait() instantly
                        # and busy-spin the loop until the primary lands
                        node2 = slot["hedge"].pop(f)
                        if slot["hedge_dead"]:
                            continue  # abandoned set; primary decides
                        slot["hedge_ok"].append((results, tr, node2))
                        if slot["hedge"]:
                            continue  # parts still outstanding
                        # the full hedge set answered first: it wins;
                        # the primary straggler is abandoned (its
                        # result is never read or grafted)
                        settle(slot)
                        if slot["primary"] is not None:
                            slot["primary"].cancel()
                        for r2, t2, _n2 in slot["hedge_ok"]:
                            graft(t2)
                            per_node.append
                        continue
                    # primary answered: it wins; queued hedge parts are
                    # cancelled, running ones abandoned
                    settle(slot)
                    for hf in (slot["hedge"] or {}):
                        hf.cancel()
                    graft(tr)
                    per_node.append(results)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        return per_node

    def _read_many(self, index: str, calls: list[Call], shards,
                   deadline: float | None = None):
        """Fan out SEVERAL Count calls as one query per node (each node
        fuses the run into one program + read); returns merged ints."""
        per_node = self._fanout_partials(index, calls, shards,
                                         deadline=deadline)
        return [sum(node_counts[i] for node_counts in per_node)
                for i in range(len(calls))]

    def _resolve_nested_limits(self, index: str, call: Call, shards,
                               *, deadline: float | None = None) -> Call:
        """Rewrite non-top-level Limit subtrees into resolved ConstRow
        literals, bottom-up (inner Limits resolve first, so a Limit
        whose child contains another Limit also works)."""
        def resolve(node: Call) -> Call:
            kids = [resolve(c) for c in node.children]
            args = {k: (resolve(v) if isinstance(v, Call) else v)
                    for k, v in node.args.items()}
            node = Call(node.name, args, kids)
            if node.name == "Limit":
                cols = self._read(index, node, shards,
                                  deadline=deadline)
                return Call("ConstRow",
                            {"columns": (cols.get("columns")
                                         or cols.get("keys") or [])})
            return node

        eff = _call_of(call)
        # the top-level Limit itself stays (strip+merge handles it
        # exactly); only its/other calls' SUBTREES rewrite
        rebuilt = Call(eff.name,
                       {k: (resolve(v) if isinstance(v, Call) else v)
                        for k, v in eff.args.items()},
                       [resolve(c) for c in eff.children])
        if call.name == "Options" and call.children:
            return Call("Options", dict(call.args), [rebuilt])
        return rebuilt

    # -- reads --------------------------------------------------------------

    def _read(self, index: str, call: Call, shards: list[int] | None,
              deadline: float | None = None):
        if call.name == "Options" and call.args.get("shards") is not None:
            # apply the shard override BEFORE any rewrite that issues
            # its own distributed reads (Extract(Limit) / nested-Limit
            # resolution) — those must page over the restricted shard
            # set, exactly as the single-node executor scopes the tree
            shards = [int(s) for s in call.args["shards"]]
        if _nested_limit(call):
            # per-node Limit then merge is NOT global Limit: column
            # order crosses node boundaries.  Resolve EVERY nested
            # Limit subtree (Extract(Limit(...)) included) as its own
            # exact top-level distributed read (limit applied on the
            # globally merged ascending column list) and substitute the
            # result as a ConstRow literal — one extra fan-out round
            # per nested Limit, exactness preserved.
            call = self._resolve_nested_limits(index, call, shards,
                                               deadline=deadline)
        call = self._translate_input(index, call)
        if call.name == "Options" and call.args.get("shards") is not None:
            # Options(shards=[...]) overrides, as in single-node
            shards = [int(s) for s in call.args["shards"]]
        # remote groups fan out CONCURRENTLY (the reference runs one
        # goroutine per node, executor.go#mapReduce); the local group
        # executes on this thread while peers work
        per_node = self._fanout_partials(index, [_strip_truncation(call)],
                                         shards, deadline=deadline)
        merged = merge_results(_call_of(call),
                               [pn[0] for pn in per_node])
        return self._translate_output(index, _call_of(call), merged)

    # -- writes -------------------------------------------------------------

    def _write(self, index: str, call: Call):
        """Replicated write with durable hinted handoff.

        Every write — strict (Clear/ClearRow/Store) or best-effort
        (Set) — keeps serving through a dead replica: the op applies
        on the write-reachable owners and is durably HINTED for the
        unreachable ones (appended to the crash-safe per-peer hint
        log; replayed in order on rejoin).  Owners known dead UP FRONT
        hint BEFORE the live applies run: a coordinator crash in
        between re-delivers (idempotently) rather than loses, and a
        torn hint append fails the op before anything mutated.  An
        owner that dies MID-APPLY necessarily hints after the
        surviving legs applied — a crash in that narrower window
        leaves an un-acked op partially applied with no hint, which
        AAE converges exactly like a handoff-less best-effort miss (the
        at-least-once contract: un-acked ops may partially apply).

        Refusal (``WriteUnavailableError`` → 503 + Retry-After) is the
        bounded fallback, not the default: handoff disabled
        (``hint_max_age <= 0`` — the handoff-less contract), a hinted
        peer's backlog past ``hint_max_age``, or no live replica left
        to apply the op right now."""
        from pilosa_tpu_torch.engine.words import SHARD_WIDTH
        if (_call_of(call).name in ("Clear", "ClearRow", "Store")
                and self.cluster.state == "RESIZING"):
            # a clear routed to the OLD owners while their fragments
            # stream to the incoming topology would be resurrected the
            # moment the new placement activates; refuse loudly until
            # the resize lands (Set stays allowed — union-merge AAE
            # repairs additive divergence)
            raise ExecutionError(
                f"{_call_of(call).name} refused during cluster resize; "
                "retry when the cluster returns to NORMAL")
        # Set/Store create missing keys; Clear/ClearRow must not
        create = _call_of(call).name in ("Set", "Store")
        call = self._translate_input(index, call, create=create)
        eff = _call_of(call)
        hints = self.cluster.hints
        if eff.name in ("Set", "Clear"):
            shard = int(eff.args["_col"]) // SHARD_WIDTH
            owners = self.cluster.shard_owners(index, shard)
            if hints is None:
                # handoff disabled: the legacy contract — Set is
                # best-effort over reachable owners (AAE repairs a
                # dead replica on rejoin), Clear fail-fasts BEFORE any
                # replica applies (a copy missed by a down node would
                # be resurrected by union-merge AAE)
                if eff.name == "Clear":
                    dead = sorted(set(owners) - self._write_reachable())
                    if dead:
                        raise self._unavailable(eff.name, dead[0],
                                                "replica_down")
                results = self._run_on(index, call, owners, shards=None,
                                       best_effort=eff.name == "Set")
                return bool(results[0])
            targets, handed = self._split_write_targets(eff.name, owners)
            hinter = self._hinter(index, call, (shard,))
            for peer in handed:
                # hint FIRST (durable intent), then apply on the live
                # owners: a crash in between re-delivers — never loses
                hinter(peer)
            results = self._run_on(index, call, targets, shards=None,
                                   best_effort=eff.name == "Set",
                                   handoff=hinter)
            if not results:
                # every live target died mid-apply (each was hinted):
                # nothing applied NOW, the same state the up-front
                # split refuses as no_live_replica — acking would
                # claim otherwise.  The hints stay queued: the
                # un-acked op may still replay (at-least-once).
                raise self._unavailable(eff.name, targets[0],
                                        "no_live_replica")
            return bool(results[0])
        # ClearRow / Store touch every shard, and every REPLICA of each
        # shard must eventually apply them (a replica that missed a
        # clear would diverge and union-merge AAE would resurrect the
        # cleared bits cluster-wide).  The shard UNIVERSE itself must
        # be complete, or shards only the unreadable peer knows about
        # would miss the clear.  Down owners get the op hinted with
        # exactly their shard group; AAE defers those fragments until
        # the hints drain, so the ordering rule holds per shard.
        try:
            all_shards = self.cluster.index_shards(index, strict=True)
        except RuntimeError as e:
            raise ExecutionError(str(e)) from e
        groups: dict[str, list[int]] = {}
        for s in all_shards:
            for o in self.cluster.shard_owners(index, s):
                groups.setdefault(o, []).append(s)
        reachable = self._write_reachable()
        dead = sorted(set(groups) - reachable)
        if dead and hints is None:
            # legacy fail-fast BEFORE mutating anything: discovering a
            # dead owner mid-loop would leave the clear half-applied
            raise self._unavailable(eff.name, dead[0], "replica_down")
        if dead:
            # at least one REACHABLE owner per shard must apply the op
            # now — with every owner of a shard down there is no live
            # copy to serve reads from either, so refuse loudly
            for s in all_shards:
                owners_s = self.cluster.shard_owners(index, s)
                if not any(o in reachable for o in owners_s):
                    raise self._unavailable(eff.name, owners_s[0],
                                            "no_live_replica")
            for o in dead:
                if hints.overflowed(o):
                    raise self._unavailable(eff.name, o, "hint_overflow")
            for o in dead:
                self._hinter(index, call, groups[o])(o)
        live = {o: s for o, s in groups.items() if o not in dead}
        from concurrent.futures import ThreadPoolExecutor

        def leg(kv):
            o, shards_o = kv
            handoff = (self._hinter(index, call, shards_o)
                       if hints is not None else None)
            rs = self._run_on(index, call, [o], shards=tuple(shards_o),
                              handoff=handoff)
            # an answered leg may legitimately return a falsy result
            # (no bits changed), so "applied" is rs non-empty, not
            # rs[0] truthiness
            return o, (rs[0] if rs else False), bool(rs)

        with ThreadPoolExecutor(max_workers=len(live)) as pool:
            legs = list(pool.map(leg, live.items()))
        if hints is not None:
            # the up-front rule re-checked against what actually
            # happened: every shard needs at least one LIVE apply —
            # an owner that died mid-apply was hinted, and if it was
            # a shard's only reachable owner the op applied nowhere
            # live for that shard (ack would claim otherwise)
            applied_on = {o for o, _r, ok in legs if ok}
            for s in all_shards:
                owners_s = self.cluster.shard_owners(index, s)
                if not any(o in applied_on for o in owners_s):
                    raise self._unavailable(eff.name, owners_s[0],
                                            "no_live_replica")
        return any(bool(r) for _o, r, _ok in legs)

    @staticmethod
    def write_failure_class(e) -> str | None:
        """Classify a write leg's ClientError — the ONE copy of the
        rule the PQL write path (:meth:`_run_on`) and the bulk-import
        coordinator (``ingest.bulk``) share.  Only never-delivered
        failures mean ``"down"``: connection refused/reset, TLS
        handshake alerts ("transport" — the handshake precedes any
        request processing).  An answered 503 is an ALIVE peer that
        shed the request pre-execution (``"busy"``): it keeps serving
        reads, so hinting it would ack a strict op that a read on that
        replica then contradicts — busy legs never hand off.  None =
        propagate: a timeout is "state unknown" (the peer may still
        apply — a hinted replay could reorder behind a newer direct
        write), and any other 5xx from an alive peer is a real failed
        write, not AAE-repairable noise."""
        if e.status == 503 and "quarantined" in str(e):
            # a QUARANTINED-fragment refusal.  The busy-never-hints
            # rationale does not apply: a quarantined fragment serves
            # NO reads (routing skips it, peer legs 503 onto the
            # failover path), so a hinted strict op can never be
            # contradicted by a read on that replica — and repair +
            # ordered drain deliver it once the fragment is healthy.
            # Without this, one quarantined replica would refuse
            # strict writes for its shard cluster-wide for the whole
            # detect→repair window.
            return "down"
        if e.status == 503:
            return "busy"
        if e.status == 507:
            # the replica's DISK is out (read-only degraded
            # serving): the node is alive, answered before mutating,
            # and will drain an ordered hint replay once its probe
            # restores healthy — exactly what handoff is for
            return "down"
        if e.status == 0 and e.kind != "timeout":
            return "down"
        return None

    def _write_reachable(self) -> set[str]:
        """The node set a write may target DIRECTLY: alive, breaker-
        closed, and — with handoff enabled — holding no pending hints.
        The breaker sees a dead peer within a few transport failures,
        seconds before the suspect horizon.  A peer with pending hints
        is not write-reachable even once alive again: new writes to it
        must append BEHIND the older hints (one ordered stream per
        peer) until the drain empties the log, or a replayed Clear
        could land after a newer direct Set and destroy it."""
        out = (set(self.cluster.alive_ids())
               - self.cluster.breakers.unhealthy_peers())
        hints = self.cluster.hints
        if hints is not None:
            out -= hints.pending_peers()
        return out

    def _split_write_targets(self, op: str, owners,
                             additive: bool | None = None
                             ) -> tuple[list[str], list[str]]:
        """(apply-now targets, hand-off peers) for one shard's owner
        set, refusing when the split cannot serve: no live replica at
        all, or a hand-off peer whose backlog overflowed
        ``hint_max_age`` (additive ops — Set, and non-clearing
        bulk imports — fall back to the legacy best-effort miss there
        instead: AAE union-merge repairs additive divergence, so
        boundedness never costs them availability).  ``additive``
        defaults from the op name for the PQL write path."""
        hints = self.cluster.hints
        if additive is None:
            additive = op == "Set"
        reachable = self._write_reachable()
        targets = [o for o in owners if o in reachable]
        dead = [o for o in owners if o not in reachable]
        if not targets:
            raise self._unavailable(op, dead[0] if dead else None,
                                    "no_live_replica")
        handed = []
        for o in dead:
            if hints.overflowed(o):
                if additive:
                    self.cluster.stats.count("write_replicas_missed", 1)
                    self.cluster.logger.warning(
                        "%s not hinted for %s (backlog older than "
                        "hint_max_age=%gs); AAE repairs on rejoin",
                        op, o, hints.max_age)
                    continue
                raise self._unavailable(op, o, "hint_overflow")
            handed.append(o)
        return targets, handed

    def _unavailable(self, op: str, replica: str | None,
                     reason: str) -> WriteUnavailableError:
        """The structured refusal every write-unavailability path
        shares: the API edges map it to 503 + Retry-After with a body
        naming the down replica (mirrors the 504 timeout block)."""
        hints = self.cluster.hints
        if reason == "replica_down":
            msg = (f"replica {replica} unreachable for {op}: this op "
                   "requires every replica (a copy missed by a down "
                   "node would be resurrected by anti-entropy union "
                   "merge, and hinted handoff is disabled)")
        elif reason == "hint_overflow":
            msg = (f"replica {replica} unreachable for {op} and its "
                   f"hint backlog is older than hint_max_age="
                   f"{hints.max_age:g}s; refusing to diverge further "
                   "(drain or remove the node)")
        elif reason == "replica_busy":
            msg = (f"replica {replica} shed {op} (executor saturated): "
                   "the peer is alive and still serving reads, so "
                   "hinting would let this strict op ack while that "
                   "replica contradicts it — retry shortly")
        else:
            msg = (f"no live replica reachable for {op}"
                   + (f" (first unreachable: {replica})" if replica
                      else ""))
        retry = max(1.0, float(getattr(self.cluster.cfg,
                                       "heartbeat_interval", 1.0)))
        return WriteUnavailableError(msg, op=op, replica=replica,
                                     reason=reason, retry_after=retry)

    def _hint_record(self, index: str, call: Call, shards) -> dict:
        """One replayable hint: the already-translated PQL plus the
        routing facts (index/field/shards) AAE gating keys on, and a
        unique 128-bit op id the receiver dedups by."""
        eff = _call_of(call)
        return {"id": os.urandom(16).hex(), "index": index,
                "pql": str(call), "op": eff.name,
                "field": self._write_field(eff),
                "shards": (sorted(int(s) for s in shards)
                           if shards is not None else None)}

    def _hinter(self, index: str, call: Call, shards):
        """A hand-off callable for one op: durably hints ``call`` for
        a peer (used both pre-apply for known-dead owners and from
        ``_run_on`` when a target dies mid-apply)."""
        hints = self.cluster.hints

        def hand_off(node_id: str, err=None) -> None:
            hints.add(node_id, self._hint_record(index, call, shards))
            self.cluster.stats.count("hint_handoff_total", 1,
                                     peer=node_id)
            self.cluster.logger.info(
                "%s hinted for %s (replica down%s)",
                _call_of(call).name, node_id,
                f": {err}" if err is not None else "")

        return hand_off

    @staticmethod
    def _write_field(eff: Call) -> str | None:
        """The field a write call targets (the single non-reserved
        field arg — the same rule the translate walk uses), or None
        when indeterminable (gating then treats the hint as covering
        every field of the index: conservative, never unsound)."""
        from pilosa_tpu_torch.exec.executor import reserved_for
        rk = reserved_for(eff.name)
        for k, v in eff.args.items():
            if (k in rk or k.startswith("_")
                    or isinstance(v, (Condition, Call))):
                continue
            return str(k)
        f = eff.args.get("_field")
        return str(f) if f is not None else None

    def _attr_write(self, index: str, call: Call):
        """SetRowAttrs/SetColumnAttrs apply on every member — attr
        stores are fully replicated.  Routed through the breaker-aware
        write-reachable set (this once fanned out over
        ``alive_ids()`` ignoring breaker state, so a sick-but-not-yet-
        suspect peer ate a connect timeout on every attrs write);
        unreachable members are durably hinted when handoff is
        enabled, else left to attr AAE as before."""
        call = self._translate_input(index, call, create=True)
        hints = self.cluster.hints
        reachable = self._write_reachable()
        members = self.cluster.member_ids()
        targets = [n for n in members if n in reachable]
        rest = [n for n in members if n not in reachable]
        handoff = None
        if hints is not None:
            hinter = self._hinter(index, call, None)
            handoff = hinter
            for peer in rest:
                if not hints.overflowed(peer):
                    hinter(peer)
        elif rest:
            self.cluster.stats.count("write_replicas_missed", len(rest))
            self.cluster.logger.warning(
                "%s skipped %d unreachable member(s) %s (attr AAE "
                "repairs on rejoin)", _call_of(call).name, len(rest),
                rest)
        self._run_on(index, call, targets, shards=None, best_effort=True,
                     handoff=handoff)
        return None

    def _run_on(self, index: str, call: Call, node_ids, shards,
                best_effort: bool = False, handoff=None):
        """Execute one call on each named node (replica-synchronous for
        writes, replicas in parallel); returns the successful results,
        primary's first.

        ``best_effort``: an unreachable node (ClientError — dead or not
        yet past the suspect horizon) is skipped as long as at least
        one owner accepts; AAE repairs it on rejoin.  Execution errors
        (validation etc.) always propagate.  A socket TIMEOUT is not
        "unreachable": the peer saw the request and may still apply
        the write after we give up, so it propagates as a hard
        failure ("state unknown") on every path — skipping it would
        undercount a write that likely applied: a hinted
        replay of a maybe-applied op could land AFTER a newer direct
        write and reorder it, so only never-delivered failures hand
        off.

        ``handoff``: a callable ``(node_id, err)`` that durably
        hints the op for a target that died mid-apply (the "down"
        class only) — the failure is then handled, not raised, and the
        op keeps serving on the surviving results."""
        from pilosa_tpu_torch.api.client import ClientError

        pql = str(call)

        def one(node_id):
            if node_id == self.cluster.node_id:
                rs = self.cluster.api.executor.execute(
                    index, Query([call]),
                    shards=list(shards) if shards else None,
                    translate_output=False)
                return result_to_json(rs[0])
            # map_unreachable=False: "down" classification below needs
            # the raw transport error; timeouts still arrive mapped as
            # ExecutionError("state unknown…") and propagate hard
            return self.cluster.internal_query(node_id, index, pql,
                                               shards,
                                               map_unreachable=False)[0]

        def guarded(node_id):
            try:
                return ("ok", one(node_id))
            except ClientError as e:
                tag = self.write_failure_class(e)
                if tag is None:
                    raise
                return (tag, (node_id, e))

        node_ids = list(node_ids)
        if len(node_ids) == 1:
            outs = [guarded(node_ids[0])]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=len(node_ids)) as pool:
                outs = list(pool.map(guarded, node_ids))
        oks = [r for tag, r in outs if tag == "ok"]
        downs = [r for tag, r in outs if tag == "down"]
        busys = [r for tag, r in outs if tag == "busy"]
        if downs and handoff is not None:
            # durable hinted handoff: targets that died mid-apply get
            # the op appended to their hint log (ordered replay on
            # rejoin) instead of failing or silently diverging
            for nid, err in downs:
                handoff(nid, err)
            downs = []
        if busys and not best_effort:
            # a saturated replica shed the op pre-execution: transient
            # unavailability, retryable — structured 503, never hinted
            nid, err = busys[0]
            raise self._unavailable(_call_of(call).name, nid,
                                    "replica_busy")
        downs += busys
        if downs and (not best_effort or not oks):
            nid, err = downs[0]
            raise ExecutionError(
                f"replica {nid} unreachable for {_call_of(call).name}: "
                f"{err}" + ("" if best_effort else
                            " (this op requires every replica: a copy "
                            "missed by a down node would be resurrected "
                            "by anti-entropy union merge)"))
        if downs:
            self.cluster.stats.count("write_replicas_missed", len(downs))
            self.cluster.logger.warning(
                "%s applied on %d/%d owners; missed %s (AAE repairs on "
                "rejoin)", _call_of(call).name, len(oks), len(node_ids),
                [nid for nid, _ in downs])
        return oks

    # -- key translation at the edge ---------------------------------------

    def _translate_input(self, index: str, call: Call,
                         create: bool = False) -> Call:
        """Replace string row/column keys with IDs (on a copy).  An
        unknown key on a read becomes ID 0 — key IDs start at 1, so the
        sub-row/column is empty, matching single-node semantics exactly
        (a missing key must not veto Not/Difference/Union siblings)."""
        idx = self.cluster.api.holder.index(index)
        if idx is None:
            raise ExecutionError(f"index {index!r} not found")

        def resolve(field: str | None, key: str) -> int:
            kid = self.cluster.translate_keys(index, field, [key],
                                              create=create)[0]
            return 0 if kid is None else kid

        def walk(c: Call) -> Call:
            new = Call(c.name, dict(c.args), [walk(ch) for ch in c.children])
            for k, v in list(new.args.items()):
                if isinstance(v, Call):
                    new.args[k] = walk(v)
            if isinstance(new.args.get("_col"), str):
                new.args["_col"] = resolve(None, new.args["_col"])
            if isinstance(new.args.get("_row"), str):
                fname = new.args.get("_field")
                f = idx.field(str(fname)) if fname else None
                if f is not None and f.options.keys:
                    new.args["_row"] = resolve(str(fname), new.args["_row"])
            if isinstance(new.args.get("column"), str):
                cid = self.cluster.translate_keys(
                    index, None, [new.args["column"]], create=False)[0]
                new.args["column"] = 0 if cid is None else cid
            # row key: the single non-reserved field arg (reservation
            # is per call — see executor.reserved_for).  Attr calls
            # never carry row keys in their kv args: an attr VALUE that
            # happens to share a keyed field's name must stay verbatim.
            if c.name in ("SetRowAttrs", "SetColumnAttrs"):
                return new
            from pilosa_tpu_torch.exec.executor import reserved_for
            rk = reserved_for(c.name)
            for k, v in list(new.args.items()):
                if (k in rk or k.startswith("_")
                        or isinstance(v, (Condition, Call))):
                    continue
                field = idx.field(k)
                if field is not None and field.options.keys \
                        and isinstance(v, str):
                    new.args[k] = resolve(k, v)
            prev = new.args.get("previous")
            if isinstance(prev, str):
                fname = new.args.get("_field") or new.args.get("field")
                rid = self.cluster.translate_keys(
                    index, str(fname), [prev], create=False)[0]
                new.args["previous"] = rid if rid is not None else _MAX_U64
            return new

        return walk(call)

    def _translate_extract(self, index: str, idx, merged):
        """Edge translation for merged Extract results: column ids →
        keys (keyed index), keyed fields' row values → keys."""
        if idx.keys:
            ids = [c.pop("column") for c in merged["columns"]]
            for c, k in zip(merged["columns"],
                            self.cluster.keys_of(index, None, ids)):
                c["key"] = k
        for fi, spec in enumerate(merged.get("fields", [])):
            f = idx.field(spec["name"])
            if f is None or not f.options.keys:
                continue
            for c in merged["columns"]:
                v = c["rows"][fi]
                if isinstance(v, list):
                    c["rows"][fi] = self.cluster.keys_of(
                        index, spec["name"], v)
                elif v is not None and not isinstance(v, bool):
                    c["rows"][fi] = self.cluster.keys_of(
                        index, spec["name"], [v])[0]
        return merged

    def _translate_output(self, index: str, call: Call, merged):
        idx = self.cluster.api.holder.index(index)
        if merged is None or idx is None:
            return merged
        if isinstance(merged, dict) and call.name == "Extract" \
                and "columns" in merged:
            return self._translate_extract(index, idx, merged)
        if isinstance(merged, dict) and "columns" in merged and idx.keys:
            keys = self.cluster.keys_of(index, None, merged["columns"])
            out = {"keys": keys}
            if merged.get("rowAttrs"):  # carried through key translation
                out["rowAttrs"] = merged["rowAttrs"]
            if merged.get("attrs"):
                # column-attr maps re-key from column ids to column keys
                # (the id axis is gone from a keyed response)
                id_to_key = {str(c): k for c, k in
                             zip(merged["columns"], keys)}
                out["attrs"] = {id_to_key.get(i, i): a
                                for i, a in merged["attrs"].items()}
            return out
        fname = call.args.get("_field") or call.args.get("field")
        field = idx.field(str(fname)) if fname else None
        keyed_field = field is not None and field.options.keys
        if isinstance(merged, list) and keyed_field:  # TopN pairs
            ids = [p["id"] for p in merged]
            keys = self.cluster.keys_of(index, str(fname), ids)
            return [{"key": k, "count": p["count"]}
                    for k, p in zip(keys, merged)]
        if isinstance(merged, dict) and "rows" in merged and keyed_field:
            keys = self.cluster.keys_of(index, str(fname), merged["rows"])
            return {"keys": keys}
        if isinstance(merged, list) and call.name == "GroupBy":
            for g in merged:
                for fr in g["group"]:
                    f = idx.field(fr["field"])
                    if f is not None and f.options.keys and "rowID" in fr:
                        fr["rowKey"] = self.cluster.keys_of(
                            index, fr["field"], [fr.pop("rowID")])[0]
        return merged



# ---------------------------------------------------------------------------
# partial-result merging (reference: the reduce fns in executor.go)
# ---------------------------------------------------------------------------


def merge_results(call: Call, partials: list):
    if not partials:
        return None
    name = call.name
    if name == "Count":
        return sum(partials)
    if name in WRITE_CALLS or name == "IncludesColumn":
        return any(partials)
    if name in ("Row", "Range", "Intersect", "Union", "Difference", "Xor",
                "Not", "All", "Shift", "UnionRows", "ConstRow", "Limit"):
        cols = np.unique(np.concatenate(
            [np.asarray(p.get("columns", []), dtype=np.uint64)
             for p in partials]))
        if name in ("All", "Limit"):
            # paging applies to the MERGED list (per-node paging was
            # stripped from the fan-out)
            offset = int(call.args.get("offset", 0))
            limit = call.args.get("limit")
            end = None if limit is None else offset + int(limit)
            cols = cols[offset:end]
        out = {"columns": [int(c) for c in cols]}
        for p in partials:  # row attrs are replicated — any node's copy
            if p.get("rowAttrs"):
                out["rowAttrs"] = p["rowAttrs"]
                break
        # column attrs (Options columnAttrs=true): each node annotates
        # its own columns; the merged map is their union
        attr_maps = [p["attrs"] for p in partials if p.get("attrs")]
        if attr_maps:
            out["attrs"] = {k: v for m in attr_maps for k, v in m.items()}
        return out
    if name == "Extract":
        from pilosa_tpu_torch.exec.executor import Executor
        fields = partials[0].get("fields", []) if partials else []
        cols = [c for p in partials for c in p.get("columns", [])]
        if len(cols) > Executor.MAX_EXTRACT_COLUMNS:
            # per-node caps pass individually; the merged result must
            # honor the same memory bound
            raise ExecutionError(
                f"Extract: {len(cols)} columns across the cluster; cap "
                f"is {Executor.MAX_EXTRACT_COLUMNS} — narrow the filter "
                "or use Limit as Extract's filter")
        cols.sort(key=lambda c: c.get("column", 0))
        return {"fields": fields, "columns": cols}
    if name == "TopN":
        counts: dict[int, int] = {}
        if partials and isinstance(partials[0], dict) and "pairs" in partials[0]:
            # tanimoto partials: sum intersection counts, row counts and
            # |src| across nodes, then threshold on the GLOBAL ratio
            row_counts: dict[int, int] = {}
            src = 0
            for p in partials:
                src += int(p.get("srcCount", 0))
                for pair in p["pairs"]:
                    i = pair["id"]
                    counts[i] = counts.get(i, 0) + pair["count"]
                    row_counts[i] = (row_counts.get(i, 0)
                                     + pair.get("rowCount", 0))
            thr = float(call.args.get("tanimoto", 0))
            pairs = sorted(
                ((i, c) for i, c in counts.items()
                 if c > 0 and 100.0 * c >= thr * (src + row_counts[i] - c)),
                key=lambda kv: (-kv[1], kv[0]))
        else:
            for p in partials:
                for pair in p:
                    counts[pair["id"]] = (counts.get(pair["id"], 0)
                                          + pair["count"])
            pairs = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        n = call.args.get("n")
        if n is not None:
            pairs = pairs[: int(n)]
        return [{"id": i, "count": c} for i, c in pairs]
    if name == "Sum":
        return {"value": sum(p["value"] for p in partials),
                "count": sum(p["count"] for p in partials)}
    if name in ("Min", "Max"):
        live = [p for p in partials if p["count"] > 0]
        if not live:
            return {"value": 0, "count": 0}
        best = (min if name == "Min" else max)(p["value"] for p in live)
        return {"value": best,
                "count": sum(p["count"] for p in live
                             if p["value"] == best)}
    if name == "Distinct":
        vals = sorted({v for p in partials for v in p.get("values", [])})
        return {"values": vals}
    if name == "Rows":
        rows = np.unique(np.concatenate(
            [np.asarray(p.get("rows", []), dtype=np.uint64)
             for p in partials]))
        limit = call.args.get("limit")
        if limit is not None:
            rows = rows[: int(limit)]
        return {"rows": [int(r) for r in rows]}
    if name == "GroupBy":
        return _merge_groupby(call, partials)
    raise ExecutionError(f"cannot merge results for call {name!r}")


# safe margin for int64 aggregate accumulation across nodes: past this,
# fall back to exact Python big-int merging (matches the executor's
# Sum host-finish policy)
_AGG_I64_BOUND = 1 << 60


def _merge_groupby(call: Call, partials: list):
    """GroupBy partial merge, vectorized (reference: the per-group map
    merge in ``executor.go#executeGroupBy`` reduce fn).

    Fast path: all group members carry numeric rowIDs and aggregates fit
    int64 — key matrix ``np.unique(axis=0)`` + ``ufunc.at`` reductions,
    no per-group dict churn (the dict merge was ~40% of a 125k-group
    distributed GroupBy).  Keyed rows or big-int aggregates take the
    exact dict path.
    """
    agg_call = call.args.get("aggregate")
    agg_op = agg_call.name if isinstance(agg_call, Call) else None
    flat = [g for p in partials for g in p]
    if not flat:
        groups = []
    else:
        fast = all("rowID" in fr for g in flat for fr in g["group"])
        if fast:
            n_nodes = len(partials)
            fast = all(
                g.get("agg") is None
                or abs(g["agg"]) * n_nodes < _AGG_I64_BOUND
                for g in flat)
        groups = (_merge_groupby_fast(flat, agg_op) if fast
                  else _merge_groupby_dicts(flat, agg_op))
    having = call.args.get("having")
    if having is not None:
        from pilosa_tpu_torch.exec.executor import Executor
        metric, cond = Executor.parse_having(having, agg_op)
        groups = [g for g in groups
                  if (g["count"] if metric == "count"
                      else g.get("agg")) is not None
                  and cond.matches(g["count"] if metric == "count"
                                   else g["agg"])]
    limit = call.args.get("limit")
    if limit is not None:
        groups = groups[: int(limit)]
    return groups


def _merge_groupby_fast(flat: list, agg_op):
    fields = [fr["field"] for fr in flat[0]["group"]]
    rows = np.array([[fr["rowID"] for fr in g["group"]] for g in flat],
                    np.uint64).reshape(len(flat), len(fields))
    counts = np.array([g["count"] for g in flat], np.int64)
    # np.unique(axis=0) sorts lexicographically by level — the same
    # rowID ordering the reference returns
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.ravel()
    n = len(uniq)
    mcounts = np.zeros(n, np.int64)
    np.add.at(mcounts, inv, counts)
    agg_vals = [g.get("agg") for g in flat]
    maggs = amask = None
    if any(a is not None for a in agg_vals):
        present = np.array([a is not None for a in agg_vals], bool)
        vals = np.array([0 if a is None else a for a in agg_vals],
                        np.int64)
        amask = np.zeros(n, bool)
        amask[inv[present]] = True
        if agg_op == "Min":
            maggs = np.full(n, np.iinfo(np.int64).max)
            np.minimum.at(maggs, inv[present], vals[present])
        elif agg_op == "Max":
            maggs = np.full(n, np.iinfo(np.int64).min)
            np.maximum.at(maggs, inv[present], vals[present])
        else:
            maggs = np.zeros(n, np.int64)
            np.add.at(maggs, inv[present], vals[present])
    out = []
    key_rows = uniq.tolist()
    for i, (krow, count) in enumerate(zip(key_rows, mcounts.tolist())):
        g = {"group": [{"field": f, "rowID": r}
                       for f, r in zip(fields, krow)],
             "count": count}
        if maggs is not None and amask[i]:
            g["agg"] = int(maggs[i])
        out.append(g)
    return out


def _merge_groupby_dicts(flat: list, agg_op):
    """Exact fallback: keyed rows and/or arbitrary-precision aggs."""
    merged: dict[tuple, dict] = {}
    for g in flat:
        key = tuple((fr["field"], fr.get("rowID", fr.get("rowKey")))
                    for fr in g["group"])
        hit = merged.get(key)
        if hit is None:
            merged[key] = dict(g)
        else:
            hit["count"] += g["count"]
            if g.get("agg") is not None:
                if hit.get("agg") is None:
                    hit["agg"] = g["agg"]
                elif agg_op == "Min":
                    hit["agg"] = min(hit["agg"], g["agg"])
                elif agg_op == "Max":
                    hit["agg"] = max(hit["agg"], g["agg"])
                else:
                    hit["agg"] = hit["agg"] + g["agg"]
    return sorted(merged.values(),
                  key=lambda g: [fr.get("rowID", 0)
                                 for fr in g["group"]])
