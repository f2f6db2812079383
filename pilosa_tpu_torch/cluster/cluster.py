"""Cluster: membership, placement, translation replication, AAE, resize
(``pilosa_tpu.cluster.cluster``'s).

Reference: ``cluster.go`` + ``gossip/`` + ``broadcast.go`` (SURVEY.md
§3.3, §3.6).  The reference uses memberlist gossip for liveness and a
coordinator-driven state machine; this rebuild keeps the shape with a
boring HTTP control plane (no gossip library; membership is explicit
and deterministic):

- membership: explicit join to seed nodes + periodic heartbeats; a node
  is suspect after 3 missed heartbeat intervals;
- coordinator: lowest node id (reference: v1 coordinator) — drives
  resize jobs and owns key-translation assignment, replicating the
  append-only key logs to every node (v1 translate-log streaming);
- placement: jump-hash shard→partition→node with ``replicas`` copies
  (:mod:`pilosa_tpu_torch.parallel.placement`);
- anti-entropy: periodic block-checksum diff + bidirectional union
  merge between replicas (reference: holder syncer, SURVEY.md §4.6);
- resize: on membership change the coordinator computes fragment
  transfers from a cluster-wide inventory and instructs holders to push
  roaring blobs to the new owners (reference: ``ResizeJob``/
  ``ResizeInstruction``).

Queries fan out via :class:`pilosa_tpu_torch.cluster.dist.DistributedExecutor`.
"""

from __future__ import annotations

import os
import threading
import time

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.cluster.breaker import BreakerBoard
from pilosa_tpu_torch.cluster.dist import DistributedExecutor
from pilosa_tpu_torch.obs import NopStats, get_logger
from pilosa_tpu_torch.parallel.placement import shard_nodes

STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_RESIZING = "RESIZING"
STATE_DEGRADED = "DEGRADED"

SUSPECT_AFTER = 3  # missed heartbeat intervals

_SHARD_CACHE_TTL = 2.0
# cache lifetime for a shard universe built while a peer fetch failed:
# long enough to stop per-query hammering of a sick peer, short enough
# that the complete view returns quickly once the peer answers
_SHARD_NEG_TTL = 0.25


class Cluster:
    def __init__(self, cfg, api, stats=None, logger=None, port: int | None = None):
        self.cfg = cfg
        self.api = api
        self.stats = stats or NopStats()
        self.logger = logger or get_logger("pilosa_tpu_torch.cluster")
        host = cfg.host
        self.port = port if port is not None else cfg.port
        self.node_id = f"{host}:{self.port}"
        self.nodes: dict[str, dict] = {
            self.node_id: {"id": self.node_id, "uri": self.node_id,
                           "state": STATE_STARTING}}
        self._last_seen: dict[str, float] = {}
        # internode TLS (upstream: internode client certs,
        # server/config.go); one context for every peer client
        from pilosa_tpu_torch.cli.config import client_ssl_of
        self._client_ssl_ctx = client_ssl_of(cfg)
        self.state = STATE_STARTING
        # ACTIVE placement topology: the node set shard_owners routes
        # by.  Joins/removals change MEMBERSHIP immediately but the
        # placement only advances when a resize job has finished
        # streaming fragments for the new set — otherwise a joining
        # node instantly "owns" shards whose data hasn't arrived and
        # queries silently undercount.
        self.placement_ids: list[str] = [self.node_id]
        # monotonic (wall-clock) version of the ACTIVE placement: rides
        # every heartbeat both ways, so a node that missed the one
        # best-effort resize-completion broadcast detects the mismatch
        # within a heartbeat interval and PULLS the newer topology
        # instead of routing by the stale one forever
        self.placement_version: float = 0.0
        self._load_placement()
        self._placement_pull = threading.Lock()  # one pull at a time
        # per-peer circuit breakers: consecutive transport failures
        # open a peer (reads route straight to replicas); half-open
        # probes ride the heartbeat loop
        self.breakers = BreakerBoard(
            threshold=getattr(cfg, "breaker_threshold", 3),
            stats=self.stats, logger=self.logger)
        # durable hinted handoff: per-peer crash-safe hint logs —
        # writes keep serving through a dead replica, the missed copy
        # replays in order on rejoin.  hint_max_age <= 0 disables
        # (the strict fail-fast contract).
        self.hints = None
        if float(getattr(cfg, "hint_max_age", 0.0) or 0.0) > 0:
            from pilosa_tpu_torch.cluster.hints import HintBoard
            self.hints = HintBoard(
                os.path.join(api.holder.path, "_hints"),
                max_age=cfg.hint_max_age, fsync=cfg.fsync,
                stats=self.stats, logger=self.logger)
        # receiver-side durable dedup window for /internal/hints/replay
        # — always on (cheap), so this node dedups a peer's replays
        # even when its own handoff is disabled
        from pilosa_tpu_torch.store.oplog import IdWindow
        self.applied_ops = IdWindow(
            os.path.join(api.holder.path, "_hints_applied.log"))
        # peers with pending INBOUND hints anywhere in the cluster:
        # holder id -> (hinted peer set, monotonic update ts).  Learned
        # from every heartbeat (both directions carry ``hintsFor``) and
        # seeded by the join response, so a rejoined stale peer and
        # every up-to-date replica both know to defer AAE union-merge
        # with each other BEFORE the first anti-entropy tick can run —
        # the ordering rule that makes a replayed Clear irresurrectable.
        self._hints_inbound: dict[str, tuple[set, float]] = {}
        self.dist = DistributedExecutor(self)
        self._clients: dict[str, object] = {}
        # index -> (fetched_at, shards, incomplete): `incomplete` rides
        # the cache so strict callers reject degraded hits too
        self._shard_cache: dict[
            str, tuple[float, tuple[int, ...], bool]] = {}
        self._lock = threading.RLock()
        self._status_ts = 0.0
        self._removed: dict[str, float] = {}  # tombstones: explicit removals
        # schema tombstones: (index, field|None) -> deletion ts; a full
        # schema push from a stale peer must not resurrect deletions
        self._schema_tombstones: dict[tuple, float] = {}
        self._resize_lock = threading.Lock()
        self._resize_abort = threading.Event()
        # set once open()'s join (and its schema pull) has completed:
        # until then a missing index cannot be judged "deleted" — the
        # HTTP server answers /internal/hints/replay before open()
        # finishes, so a drain kicked by our own join request can race
        # the join response's apply_schema
        self._schema_ready = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- placement persistence ----------------------------------------------

    def _placement_path(self) -> str:
        import os
        return os.path.join(self.api.holder.path, "_cluster.json")

    def _load_placement(self) -> None:
        """Last activated topology survives restarts: a coordinator
        that cold-restarts alone must NOT serve with placement=[self]
        (it would silently route every shard to itself and undercount)
        — it keeps routing by the persisted topology, failing loudly
        for shards whose owners haven't rejoined yet."""
        import json as _json
        import os
        try:
            with open(self._placement_path()) as f:
                data = _json.load(f)
                saved = data.get("placement") or []
        except (OSError, ValueError):
            return
        if saved and self.node_id in saved:
            self.placement_ids = sorted(saved)
            self.placement_version = float(data.get("version", 0.0))

    def _save_placement(self) -> None:
        import json as _json
        try:
            tmp = self._placement_path() + ".tmp"
            with open(tmp, "w") as f:
                _json.dump({"placement": self.placement_ids,
                            "version": self.placement_version}, f)
            import os
            os.replace(tmp, self._placement_path())
        except OSError as e:
            self.logger.warning("placement persist failed: %s", e)

    # -- lifecycle ----------------------------------------------------------

    def open(self) -> "Cluster":
        joined = False
        for seed in self.cfg.seeds:
            if seed == self.node_id:
                continue
            try:
                resp = self._client(seed)._json(
                    "POST", "/internal/join",
                    {"id": self.node_id, "uri": self.node_id})
                now = time.monotonic()
                with self._lock:
                    self.nodes = {n["id"]: n for n in resp["nodes"]}
                    for nid in self.nodes:
                        self._last_seen.setdefault(nid, now)
                    self.state = resp.get("state", STATE_NORMAL)
                    self.placement_ids = sorted(
                        resp.get("placement") or self.nodes)
                    self.placement_version = float(
                        resp.get("placementVersion", 0.0))
                    self._save_placement()
                for t in resp.get("schemaTombstones", []):
                    self.record_schema_tombstone(t["index"], t.get("field"),
                                                 t.get("ts", 0.0))
                # seed the inbound-hints view from the join response:
                # a REJOINING node may itself be the hinted peer, and
                # it must defer its own AAE participation before its
                # first anti-entropy tick (heartbeats refresh the view
                # within one interval; this closes the boot window)
                self._note_hints_inbound(
                    "<join>", set(resp.get("hintedPeers", [])))
                self.api.apply_schema(
                    self.filter_schema(resp.get("schema", [])))
                self._pull_translate_tails(seed)
                joined = True
                self.logger.info("joined cluster via %s (%d nodes)", seed,
                                 len(self.nodes))
                # ask the coordinator to rebalance onto the new membership
                # (the seed we joined through may not be the coordinator —
                # and WE might be it, if our id sorts lowest)
                coord = self.coordinator_id()
                if coord == self.node_id:
                    self.trigger_resize()
                else:
                    try:
                        self._client(coord)._json(
                            "POST", "/internal/resize/trigger", {})
                    except Exception as e:  # noqa: BLE001
                        self.logger.warning("resize trigger failed: %s", e)
                break
            except Exception as e:  # noqa: BLE001 — try next seed
                self.logger.warning("join via %s failed: %s", seed, e)
        if not joined:
            self.logger.info("no seeds joinable; starting as single node")
        with self._lock:
            self.nodes.setdefault(
                self.node_id, {"id": self.node_id, "uri": self.node_id})
            self.nodes[self.node_id]["state"] = STATE_NORMAL
            if self.state == STATE_STARTING:
                self.state = STATE_NORMAL
        self._schema_ready.set()
        self._spawn(self._heartbeat_loop, "heartbeat")
        if self.cfg.anti_entropy_interval > 0:
            self._spawn(self._aae_loop, "anti-entropy")
        return self

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        if self.hints is not None:
            self.hints.close()
        self.applied_ops.close()

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=f"pilosa-{name}", daemon=True)
        t.start()
        self._threads.append(t)

    # -- membership ---------------------------------------------------------

    def _client(self, node_id: str):
        from pilosa_tpu_torch.api.client import Client
        with self._lock:
            c = self._clients.get(node_id)
            if c is None:
                host, port = node_id.rsplit(":", 1)
                # idempotent_posts: every /internal/* POST is idempotent
                # by contract (cluster/internal.py module docstring), so
                # the lost-response retry is safe for internode calls
                c = self._clients[node_id] = Client(
                    host, int(port), ssl_context=self._client_ssl_ctx,
                    idempotent_posts=True)
            return c

    def member_ids(self) -> list[str]:
        with self._lock:
            return sorted(self.nodes)

    def alive_ids(self) -> list[str]:
        now = time.monotonic()
        horizon = SUSPECT_AFTER * self.cfg.heartbeat_interval
        with self._lock:
            return sorted(
                nid for nid in self.nodes
                if nid == self.node_id
                or now - self._last_seen.get(nid, now) < horizon)

    def coordinator_id(self) -> str:
        """Lowest alive node id (reference: v1 coordinator election by
        ordering)."""
        return self.alive_ids()[0]

    def is_coordinator(self) -> bool:
        return self.coordinator_id() == self.node_id

    def handle_join(self, node: dict) -> dict:
        with self._lock:
            self._removed.pop(node["id"], None)  # explicit rejoin clears
            is_new = node["id"] not in self.nodes
            self.nodes[node["id"]] = {**node, "state": STATE_NORMAL}
            self._last_seen[node["id"]] = time.monotonic()
        # a node that rejoined through the membership path is routable
        # again NOW — stale breaker history must not make its shards
        # pay failover detours until a probe happens by
        self.breakers.reset(node["id"])
        # rejoin hook: start draining any hints queued for it while it
        # was down (writes keep hinting until the drain empties — the
        # per-peer stream stays ordered)
        self._drain_hints_async(node["id"])
        if is_new:
            # propagate the tombstone clear: every peer must re-admit the
            # rejoining node or its heartbeats keep getting bounced
            self._broadcast_status(cleared=[node["id"]])
            if self.is_coordinator():
                self.trigger_resize()
        with self._lock:
            tombs = [{"index": i, "field": f, "ts": ts}
                     for (i, f), ts in self._schema_tombstones.items()]
        return {"nodes": list(self.nodes.values()), "state": self.state,
                "placement": list(self.placement_ids),
                "placementVersion": self.placement_version,
                "schema": self.api.schema(), "schemaTombstones": tombs,
                "hintedPeers": sorted(self.hinted_peers())}

    def handle_heartbeat(self, node_id: str, state: str,
                         placement_version: float = 0.0,
                         hints_for: list[str] | None = None) -> dict:
        self._note_hints_inbound(node_id, set(hints_for or ()))
        with self._lock:
            if node_id in self._removed:
                # tombstoned: tell the sender it was removed; it must
                # rejoin explicitly to come back
                return {"id": self.node_id, "state": self.state,
                        "removed": True}
            self._last_seen[node_id] = time.monotonic()
            unknown = node_id not in self.nodes
            if unknown:
                # node knows us but we lost it (e.g. restarted): re-add
                self.nodes[node_id] = {"id": node_id, "uri": node_id,
                                       "state": state}
            else:
                # keep the sender's state FRESH: a restarted seed node
                # re-learns its peers from their heartbeats, and the
                # first one may arrive while the sender is still
                # DEGRADED from the outage — pinning that snapshot
                # forever left the rejoined cluster reporting DEGRADED
                # members after everyone had recovered
                self.nodes[node_id]["state"] = state
            ours = self.placement_version
        if unknown or placement_version > ours:
            # pull the sender's full cluster state off-thread (this
            # runs in an HTTP handler; the pull is its own round trip).
            # Newer placementVersion: the sender activated a topology
            # we missed.  UNKNOWN sender: our membership view is stale
            # (we restarted and lost it) — the version check alone
            # cannot heal that, because placement_version is persisted
            # across restarts while membership is not: two nodes that
            # both cold-restarted (e.g. the seed and a peer killed
            # together) each re-learn only nodes that heartbeat THEM
            # and never each other, wedging membership in an
            # asymmetric split (surfaced by chaos
            # coordinator_crash_hint_log)
            threading.Thread(target=self._pull_cluster_state,
                             args=(node_id,),
                             name="pilosa-placement-pull",
                             daemon=True).start()
        return {"id": self.node_id, "state": self.state,
                "placementVersion": ours,
                "hintsFor": (sorted(self.hints.pending_peers())
                             if self.hints is not None else [])}

    def status_payload(self) -> dict:
        """The full cluster-state snapshot served at
        ``/internal/cluster/state`` and broadcast after membership /
        placement changes."""
        with self._lock:
            return {"nodes": list(self.nodes.values()),
                    "state": self.state,
                    "placement": list(self.placement_ids),
                    "placementVersion": self.placement_version,
                    # replica factor rides along so external placement
                    # walkers (the backup/restore drivers) can compute
                    # shard_nodes without a config side channel
                    "replicas": self.cfg.replicas,
                    "ts": time.time()}

    def _pull_cluster_state(self, node_id: str) -> None:
        """Fetch a peer's cluster state and apply it (pull-on-mismatch
        convergence for missed broadcasts).  Single-flight: heartbeats
        from several newer peers must not stack redundant pulls."""
        if not self._placement_pull.acquire(blocking=False):
            return
        try:
            payload = self._client(node_id)._json(
                "GET", "/internal/cluster/state")
            self.handle_status(payload)
        except Exception as e:  # noqa: BLE001 — retried next heartbeat
            self.logger.warning("placement pull from %s failed: %s",
                                node_id, e)
        finally:
            self._placement_pull.release()

    def handle_status(self, payload: dict) -> None:
        now = time.monotonic()
        with self._lock:
            # out-of-order guard: RESIZING->NORMAL broadcasts may race
            if payload.get("ts", float("inf")) < self._status_ts:
                return
            self._status_ts = payload.get("ts", self._status_ts)
            for cleared_id in payload.get("cleared", []):
                self._removed.pop(cleared_id, None)
            # MERGE membership: a broadcast snapshotted before a
            # concurrent join must not evict the newer node (nodes are
            # only removed explicitly, never by omission); tombstoned
            # nodes stay out even if a stale snapshot carries them
            for n in payload["nodes"]:
                if n["id"] in self._removed:
                    continue
                if n["id"] == self.node_id:
                    # our OWN state is authoritative: a peer's snapshot
                    # may predate our recovery, and (now that heartbeat
                    # states stay fresh) a DEGRADED-era echo would
                    # latch in our self entry forever — nothing else
                    # ever rewrites it
                    continue
                self.nodes[n["id"]] = n
                self._last_seen.setdefault(n["id"], now)
            self.state = payload["state"]
            pv = float(payload.get("placementVersion",
                                   payload.get("ts", 0.0)))
            if payload.get("placement") and pv >= self.placement_version:
                # version-gated: a stale peer's snapshot (e.g. a pull
                # answered from an even older node) must not regress an
                # already-activated topology
                self.placement_ids = sorted(payload["placement"])
                self.placement_version = pv
                self._save_placement()

    def _broadcast_status(self, cleared: list[str] | None = None) -> None:
        payload = self.status_payload()
        if cleared:
            payload["cleared"] = cleared
        for nid in self.member_ids():
            if nid == self.node_id:
                continue
            if fault.ACTIVE:
                spec = fault.fire("cluster.broadcast", peer=nid,
                                  path="/internal/cluster/status")
                # only `drop` skips the send (a triggered `delay`
                # already slept and the broadcast must still go out):
                # the peer must then converge via the placement
                # version riding heartbeats (pull-on-mismatch)
                if spec is not None and spec["action"] == "drop":
                    self.logger.warning("fault: status broadcast to %s "
                                        "dropped", nid)
                    continue
            try:
                self._client(nid)._json("POST", "/internal/cluster/status",
                                        payload)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("status broadcast to %s failed: %s",
                                    nid, e)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.cfg.heartbeat_interval):
            self._heartbeat_once()

    def _heartbeat_once(self) -> None:
        """One heartbeat round (split out so tests can drive rounds
        deterministically)."""
        for nid in self.member_ids():
            if nid == self.node_id:
                continue
            # this round's heartbeat doubles as the breaker's half-open
            # probe: an OPEN peer steps to HALF_OPEN, then the result
            # below either closes it or re-opens it
            self.breakers.begin_probe(nid)
            try:
                resp = self._client(nid)._json(
                    "POST", "/internal/heartbeat",
                    {"id": self.node_id, "state": self.state,
                     "placementVersion": self.placement_version,
                     # pending-hint advertising rides every heartbeat
                     # both ways: the whole cluster learns which peers
                     # must not be AAE-synced within one interval
                     "hintsFor": (sorted(self.hints.pending_peers())
                                  if self.hints is not None else [])})
                self.breakers.record_success(nid)
                if resp.get("removed"):
                    # we were explicitly removed: drop to single-node
                    # membership (an operator rejoin brings us back)
                    self.logger.warning(
                        "this node was removed from the cluster by %s",
                        nid)
                    with self._lock:
                        self.nodes = {self.node_id:
                                      self.nodes.get(self.node_id,
                                                     {"id": self.node_id,
                                                      "uri": self.node_id,
                                                      "state": self.state})}
                    break
                with self._lock:
                    self._last_seen[nid] = time.monotonic()
                self._note_hints_inbound(nid,
                                         set(resp.get("hintsFor", ())))
                if (self.hints is not None
                        and self.hints.has_pending(nid)):
                    # the peer answered: it is reachable again — drain
                    # its hint backlog off-thread (single-flight)
                    self._drain_hints_async(nid)
                if (resp.get("placementVersion", 0.0)
                        > self.placement_version):
                    # the PEER activated a placement we missed (its
                    # broadcast is best-effort): pull it now — inline,
                    # this loop is already a background thread
                    self._pull_cluster_state(nid)
            except Exception as e:  # noqa: BLE001 — peer down
                from pilosa_tpu_torch.api.client import ClientError
                if isinstance(e, ClientError) and e.status != 0:
                    # the peer ANSWERED (an HTTP error): alive for
                    # breaker purposes — only never-answered requests
                    # count toward opening, same rule as internal_query
                    # (an erroring-but-alive peer must not have its
                    # strict writes refused via _write_reachable)
                    self.breakers.record_success(nid)
                else:
                    self.breakers.record_failure(nid)
        alive = set(self.alive_ids())
        with self._lock:
            dead = set(self.nodes) - alive
            new_state = (STATE_DEGRADED if dead and
                         self.state == STATE_NORMAL else self.state)
            if new_state != self.state:
                self.logger.warning("nodes suspect: %s", sorted(dead))
                self.state = new_state
            if not dead and self.state == STATE_DEGRADED:
                self.state = STATE_NORMAL

    # -- hinted handoff ------------------------------------------------

    def _note_hints_inbound(self, holder: str, peers: set) -> None:
        """Record one holder's advertised pending-hint peer set (an
        empty set clears its entry — the holder's drain finished)."""
        with self._lock:
            if peers:
                self._hints_inbound[holder] = (set(peers),
                                               time.monotonic())
            else:
                self._hints_inbound.pop(holder, None)

    def hinted_peers(self) -> set[str]:
        """Every peer with pending hinted writes anywhere in the
        cluster — this node's own board plus what peers advertised on
        their heartbeats.  AAE defers all union-merge with these peers
        (and a node finding ITSELF here defers its own participation):
        its copies are stale until the replay lands, and a sync now
        could resurrect a cleared bit.

        Advertised entries expire after the suspect horizon: a holder
        that stopped refreshing is down, and gating forever on its
        word would leave the hinted peer unrepairable.  (Caveat: if a
        hint HOLDER stays dead past the horizon while its hinted peer
        rejoins, AAE may converge the stale copy before the holder
        returns to drain — a double failure the ``hint_max_age`` bound
        keeps narrow; see the README runbook.)"""
        horizon = SUSPECT_AFTER * self.cfg.heartbeat_interval
        now = time.monotonic()
        out: set[str] = set()
        with self._lock:
            stale = [h for h, (_, ts) in self._hints_inbound.items()
                     if now - ts > horizon]
            for h in stale:
                del self._hints_inbound[h]
            for peers, _ts in self._hints_inbound.values():
                out |= peers
        if self.hints is not None:
            out |= self.hints.pending_peers()
        return out

    def _drain_hints_async(self, peer: str) -> None:
        """Kick a background replay of ``peer``'s hint backlog (no-op
        when empty or already draining)."""
        if self.hints is None or not self.hints.has_pending(peer) \
                or peer == self.node_id:
            return
        threading.Thread(target=self._drain_hints, args=(peer,),
                         name="pilosa-hint-drain", daemon=True).start()

    def _drain_hints(self, peer: str) -> None:
        """Replay ``peer``'s hint log in append order via the
        idempotent ``/internal/hints/replay`` endpoint, acking (and
        compacting) batch by batch.  Single-flight per peer; a failed
        batch aborts and the next heartbeat retries.  Writes landing
        mid-drain keep appending behind the cursor — the loop runs
        until the log is empty, and the write path only resumes direct
        sends once ``pending_peers`` no longer lists the peer."""
        hints = self.hints
        if hints is None:
            return
        lock = hints.drain_lock(peer)
        if not lock.acquire(blocking=False):
            return
        try:
            batch_n = max(1, int(getattr(self.cfg, "hint_replay_batch",
                                         256)))
            total = 0
            while True:
                batch = hints.peek(peer, batch_n)
                if not batch:
                    break
                resp = self._client(peer)._json(
                    "POST", "/internal/hints/replay",
                    {"ops": [rec for _seq, rec in batch]})
                hints.ack(peer, batch[-1][0])
                total += len(batch)
                self.stats.count("hint_replay_total", len(batch),
                                 peer=peer)
                if resp.get("dropped"):
                    self.stats.count("hint_replay_dropped_total",
                                     resp["dropped"], peer=peer)
            if total:
                self.logger.info(
                    "hints: drained %d op(s) to %s; direct writes "
                    "resume", total, peer)
        except Exception as e:  # noqa: BLE001 — retried next heartbeat
            self.logger.warning("hint replay to %s failed: %s", peer, e)
        finally:
            lock.release()

    def write_health_payload(self) -> dict:
        """The ``writeHealth`` block on ``/status``: hint backlog and
        age (total + per peer), the configured bound, and the
        cluster-wide hinted-peer view AAE gating acts on."""
        out: dict = {"hintedHandoff": self.hints is not None}
        if self.hints is None:
            return out
        out["hintMaxAgeSeconds"] = float(self.cfg.hint_max_age)
        out.update(self.hints.summary())
        out["hintedPeers"] = sorted(self.hinted_peers())
        return out

    # -- schema broadcast ---------------------------------------------------

    def _broadcast(self, path: str, payload: dict, what: str) -> None:
        """POST a cluster message to every peer, best-effort (the
        shared loop behind schema/status/delete broadcasts)."""
        for nid in self.member_ids():
            if nid == self.node_id:
                continue
            if fault.ACTIVE:
                spec = fault.fire("cluster.broadcast", peer=nid,
                                  path=path)
                if spec is not None and spec["action"] == "drop":
                    self.logger.warning("fault: %s broadcast to %s "
                                        "dropped", what, nid)
                    continue
            try:
                self._client(nid)._json("POST", path, payload)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("%s broadcast to %s failed: %s",
                                    what, nid, e)

    def broadcast_schema(self) -> None:
        """Push the full schema to every peer (reference: CreateIndex/
        Field broadcast messages)."""
        self._broadcast("/internal/schema",
                        {"schema": self.api.schema()}, "schema")

    def broadcast_delete(self, index: str, field: str | None) -> None:
        """Propagate index/field deletion to every peer, recording a
        tombstone so stale full-schema pushes cannot resurrect it
        (reference: DeleteIndex/DeleteField broadcast messages)."""
        ts = time.time()
        with self._lock:
            self._schema_tombstones[(index, field)] = ts
        self._broadcast("/internal/schema/delete",
                        {"index": index, "field": field, "ts": ts},
                        "delete")

    def record_schema_tombstone(self, index: str, field: str | None,
                                ts: float) -> None:
        with self._lock:
            cur = self._schema_tombstones.get((index, field), 0.0)
            self._schema_tombstones[(index, field)] = max(cur, ts)

    def schema_settled(self, index: str, field: str | None) -> bool:
        """True when a LOCALLY-missing index/field can be judged
        deleted (hint-replay receiver drops the op) rather than
        not-yet-learned (receiver answers 503 so the sender's drain
        retries): boot-time join with its schema pull has completed,
        or a tombstone explicitly records the deletion.  Without this
        a drain racing a rejoiner's schema pull would permanently drop
        an acked write for an index created while the node was down."""
        if self._schema_ready.is_set():
            return True
        with self._lock:
            return ((index, None) in self._schema_tombstones
                    or (field is not None
                        and (index, field) in self._schema_tombstones))

    def filter_schema(self, schema: list[dict]) -> list[dict]:
        """Drop schema entries deleted AFTER their creation: an entry
        whose created_at predates its tombstone is a stale resurrection;
        a genuine recreate carries a newer created_at and passes."""
        with self._lock:
            tombs = dict(self._schema_tombstones)
        if not tombs:
            return schema
        out = []
        for ispec in schema:
            its = tombs.get((ispec["name"], None), 0.0)
            if ispec.get("createdAt", 0.0) <= its:
                continue
            fields = [f for f in ispec.get("fields", [])
                      if f.get("createdAt", 0.0)
                      > tombs.get((ispec["name"], f["name"]), 0.0)]
            out.append({**ispec, "fields": fields})
        return out

    # -- placement / routing -------------------------------------------------

    def shard_owners(self, index: str, shard: int) -> list[str]:
        """Replica owner node ids, primary first — computed over the
        ACTIVE placement topology (NOT raw membership: a just-joined
        node owns nothing until its resize finishes and the new
        topology is activated + broadcast).  Callers fail over with
        ``alive_ids``."""
        with self._lock:
            plist = list(self.placement_ids)
        return shard_nodes(index, shard, plist, self.cfg.replicas)

    def group_shards_by_node(self, index: str, shards: tuple[int, ...],
                             exclude=frozenset()) -> dict[str, tuple]:
        """Route each shard to one alive owner, replicas in placement
        order.  Peers with a non-closed breaker are SKIPPED while a
        healthy replica exists (straight to the replica — no per-query
        connect-timeout tax on a sick peer), but remain a last resort:
        the breaker is an optimization, never a correctness gate.
        ``exclude`` drops nodes entirely — read failover passes the
        nodes that already failed the leg."""
        alive = set(self.alive_ids()) - set(exclude)
        healthy = alive - self.breakers.unhealthy_peers()
        sh = getattr(self.api.holder, "storage_health", None)
        groups: dict[str, list[int]] = {}
        for s in shards:
            owners = self.shard_owners(index, s)
            target = next((o for o in owners if o in healthy), None)
            if target is None:
                target = next((o for o in owners if o in alive), None)
            if target is None:
                raise RuntimeError(
                    f"no alive replica for shard {s} of {index!r} "
                    f"(owners {owners})")
            if (target == self.node_id and sh is not None
                    and sh.shard_quarantined(index, s)):
                # a LOCAL fragment of this shard is quarantined
                # (corrupt): serve the shard from a replica
                # exactly as if it were remote.  Self remains the last
                # resort — with no live replica a loud quarantined
                # answer still beats a refused read.
                alt = next((o for o in owners
                            if o in healthy and o != self.node_id),
                           None)
                if alt is None:
                    alt = next((o for o in owners
                                if o in alive and o != self.node_id),
                               None)
                if alt is not None:
                    target = alt
            groups.setdefault(target, []).append(s)
        return {k: tuple(v) for k, v in groups.items()}

    def index_shards(self, index: str,
                     strict: bool = False) -> tuple[int, ...]:
        """Cluster-wide shard universe for an index (short-TTL cache).

        When an ALIVE peer's shard list can't be fetched (one retry),
        the universe is INCOMPLETE: with ``strict`` that raises — a
        query served over it silently undercounts, and a ClearRow/Store
        that misses the sick peer's exclusive shards would later be
        resurrected cluster-wide by union-merge AAE.
        Non-strict callers (AAE sweeps, resize planning) get the
        degraded view, cached only for ``_SHARD_NEG_TTL`` so recovery
        is quick but a sick peer isn't hammered per query.

        Replica bound: with ``replicas`` copies, every shard has
        ``replicas`` holders — as long as the unheard nodes (fetch
        failures plus suspect members, which are never polled) number
        fewer than the replica factor, at least one holder of every
        shard was polled, so the union is still the complete universe
        and reads keep serving through a dead node instead of 500ing
        until the suspect horizon drops it.  With zero fetch failures
        the suspect count alone never marks incompleteness (baseline
        semantics: a dead node's exclusive shards are unreachable
        whether their ids are known or not — refusing every strict
        read on a degraded replicas=1 cluster would brick it).
        (Caveat: an orphan fragment held only by the sick peer
        mid-resize can hide; AAE's handoff window is the same exposure
        the replica bound leaves.)  Peers with an OPEN breaker are counted
        as failed without paying the connect attempts."""
        def raise_incomplete():
            raise RuntimeError(
                f"shard universe for {index!r} is incomplete (an alive "
                "peer's shard list is unreadable); refusing to serve a "
                "silent partial answer")

        now = time.monotonic()
        with self._lock:
            hit = self._shard_cache.get(index)
            if hit is not None and now - hit[0] < _SHARD_CACHE_TTL:
                if hit[2] and strict:
                    raise_incomplete()
                return hit[1]
        failed = 0
        shards: set[int] = set()
        idx = self.api.holder.index(index)
        if idx is not None:
            shards.update(idx.available_shards())

        def fetch(nid) -> bool:
            try:
                try:
                    resp = self._client(nid)._json(
                        "GET", f"/internal/shards?index={index}")
                except Exception:  # noqa: BLE001 — one retry
                    resp = self._client(nid)._json(
                        "GET", f"/internal/shards?index={index}")
                shards.update(resp["shards"])
                return True
            except Exception as e:  # noqa: BLE001
                self.logger.warning(
                    "shard list from %s failed: %r", nid, e)
                return False

        bound = max(1, int(self.cfg.replicas))
        alive = set(self.alive_ids())
        with self._lock:
            members = set(self.placement_ids) | set(self.nodes)
        # SUSPECT members are never polled; they count toward the
        # bound when PAIRED with a fetch failure — a dead owner plus a
        # transient failure on its co-replica can cover all holders of
        # a shard, and declaring that complete silently undercounts.
        # With no fetch failures the universe keeps baseline semantics:
        # a suspect node's exclusive shards are unreachable whether we
        # know their ids or not, and refusing every strict read on a
        # degraded replicas=1 cluster would brick it for no gain.
        suspect = len(members - alive - {self.node_id})
        deferred = []  # open-breaker peers: skip the connect tax...
        for nid in sorted(alive):
            if nid == self.node_id:
                continue
            if self.breakers.state(nid) == "open":
                deferred.append(nid)
                continue
            if not fetch(nid):
                failed += 1

        def at_risk(n_failed: int) -> bool:
            return n_failed >= 1 and n_failed + suspect >= bound

        if at_risk(failed + len(deferred)):
            # ... unless skipping them would make the universe
            # incomplete — the breaker is never a correctness gate, so
            # give the open peers their chance to answer
            failed += sum(not fetch(nid) for nid in deferred)
        else:
            failed += len(deferred)
        incomplete = at_risk(failed)
        out = tuple(sorted(shards)) if shards else (0,)
        with self._lock:
            if incomplete:
                # short negative TTL: retry soon, but don't let
                # non-strict callers hammer a sick peer in the meantime
                self._shard_cache[index] = (
                    now - _SHARD_CACHE_TTL + _SHARD_NEG_TTL, out, True)
            else:
                self._shard_cache[index] = (now, out, False)
        if incomplete and strict:
            raise_incomplete()
        return out

    def internal_query(self, node_id: str, index: str, pql: str,
                       shards, deadline: float | None = None,
                       map_unreachable: bool = True,
                       trace: dict | None = None) -> list:
        """Run ``pql`` on ``node_id`` via ``/internal/query``.

        ``trace`` (cross-node span fan-in): a mutable dict whose
        ``headers`` carry the coordinator's ``Traceparent``; on return
        it gains ``profile`` (the peer's finished span subtree, JSON)
        and ``retried`` (the transport redelivered the request), which
        the dist layer grafts into the coordinator's span tree.

        Error mapping: every failure leaves here as an
        executor exception the API layer answers with 4xx/504 — except
        kind=="unreachable" when ``map_unreachable=False``, which write
        replication (`dist._run_on`) needs verbatim to distinguish
        "peer never saw the write" (safe to skip best-effort) from
        "peer may have applied it" (state unknown — never skippable).
        """
        from pilosa_tpu_torch.api.client import ClientError
        from pilosa_tpu_torch.exec.executor import (ExecutionError,
                                              QueryTimeoutError)
        path = f"/internal/query?index={index}"
        if shards:
            path += "&shards=" + ",".join(str(s) for s in shards)
        socket_timeout = None
        if deadline is not None:
            # ship the REMAINING budget: the peer re-anchors it on its
            # own monotonic clock (wall clocks may disagree; budgets
            # don't).  An already-expired budget fails here.  The
            # socket timeout follows the budget (+slack for transfer
            # and the peer's own 504 answer) — the Client default would
            # otherwise cap every remote leg at 60 s regardless of the
            # query's deadline.
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise QueryTimeoutError("query timeout exceeded")
            path += f"&timeout={remaining:.6f}"
            socket_timeout = remaining + 10.0
        client = self._client(node_id)
        try:
            resp = client._do(
                "POST", path, pql.encode(),
                headers=(trace or {}).get("headers"),
                timeout=socket_timeout)
            self.breakers.record_success(node_id)
            if trace is not None:
                trace["profile"] = resp.get("profile") or []
                trace["retried"] = client.last_retried()
            return resp["results"]
        except ClientError as e:
            # breaker accounting: only never-answered transport faults
            # count toward opening (an HTTP error means the peer is
            # alive; a post-send timeout may be the query's fault)
            if e.status == 0 and e.kind in ("unreachable", "transport"):
                self.breakers.record_failure(node_id)
            elif e.status != 0:
                self.breakers.record_success(node_id)
            if e.status in (408, 504):
                # peer's share of the budget expired (504;
                # 408 kept for mixed-version peers mid-upgrade)
                raise QueryTimeoutError(str(e)) from e
            if e.status == 400:
                # peer rejected the query itself: surface as a query
                # error (HTTP 400 at the public edge), not a node fault
                raise ExecutionError(str(e)) from e
            if e.kind == "timeout":
                # the request was SENT; the peer may still be working
                # (or may yet apply a write) — state unknown, never
                # classed as "node down"
                if deadline is not None:
                    raise QueryTimeoutError(
                        f"remote leg on {node_id} outran the query "
                        f"deadline: {e}") from e
                raise ExecutionError(
                    f"request to {node_id} timed out; state unknown "
                    f"on that node: {e}") from e
            if map_unreachable and e.kind != "http":
                raise ExecutionError(
                    f"node {node_id} unreachable: {e}") from e
            raise

    # -- key translation (coordinator-assigned, replicated logs) ------------

    def translate_keys(self, index: str, field: str | None,
                       keys: list[str], create: bool) -> list[int | None]:
        log = (self.api.executor.translate.columns(index) if field is None
               else self.api.executor.translate.rows(index, field))
        ids = log.translate(keys, create=False)
        if all(i is not None for i in ids) or not create:
            return ids
        if self.is_coordinator():
            ids = log.translate(keys, create=True)
            self._replicate_keys(index, field, log)
            return ids
        resp = self._client(self.coordinator_id())._json(
            "POST", "/internal/translate",
            {"index": index, "field": field, "keys": keys, "create": True})
        # the coordinator replicated synchronously; but don't rely on it
        self._sync_log_from_coordinator(index, field, log)
        return resp["ids"]

    def handle_translate(self, index: str, field: str | None,
                         keys: list[str], create: bool) -> list[int | None]:
        if not self.is_coordinator() and create:
            raise PermissionError("not the coordinator")
        log = (self.api.executor.translate.columns(index) if field is None
               else self.api.executor.translate.rows(index, field))
        ids = log.translate(keys, create=create)
        if create:
            self._replicate_keys(index, field, log)
        return ids

    # Keys per page when streaming translate tails between nodes — a
    # 10M-key store syncs as ~100 bounded responses, not one giant one.
    TRANSLATE_PAGE = 100_000

    def _replicate_keys(self, index: str, field: str | None, log) -> None:
        """Best-effort synchronous replication of the tail each batch,
        paged (logs are append-only; peers dedupe)."""
        f = field or ""
        for nid in self.alive_ids():
            if nid == self.node_id:
                continue
            try:
                peer_len = self._client(nid)._json(
                    "GET", f"/internal/translate/len?index={index}"
                    f"&field={f}")["len"]
                while True:
                    tail = log.tail(peer_len, limit=self.TRANSLATE_PAGE)
                    if not tail:
                        break
                    self._client(nid)._json(
                        "POST", "/internal/translate/replicate",
                        {"index": index, "field": field,
                         "start_id": peer_len + 1, "keys": tail})
                    peer_len += len(tail)
                    if len(tail) < self.TRANSLATE_PAGE:
                        break
            except Exception as e:  # noqa: BLE001 — repaired by pull later
                self.logger.warning("translate replicate to %s failed: %s",
                                    nid, e)

    def _tail_path(self, index: str, field: str | None, after: int) -> str:
        f = field or ""
        return (f"/internal/translate/tail?index={index}&field={f}"
                f"&after={after}&limit={self.TRANSLATE_PAGE}")

    def _pull_log_tail(self, source: str, index: str, field: str | None,
                       log) -> None:
        """Pull a peer's tail into ``log``, paged until caught up."""
        while True:
            resp = self._client(source)._json(
                "GET", self._tail_path(index, field, len(log)))
            if not resp["keys"]:
                break
            log.append_replicated(len(log) + 1, resp["keys"])
            if len(log) >= resp.get("len", 0):
                break

    def _sync_log_from_coordinator(self, index: str, field: str | None,
                                   log) -> None:
        coord = self.coordinator_id()
        if coord == self.node_id:
            return
        try:
            self._pull_log_tail(coord, index, field, log)
        except Exception as e:  # noqa: BLE001
            self.logger.warning("translate tail pull failed: %s", e)

    def _pull_translate_tails(self, seed: str) -> None:
        """On join: pull every key log the seed has."""
        try:
            listing = self._client(seed)._json("GET", "/internal/translate/logs")
        except Exception:  # noqa: BLE001
            return
        for entry in listing.get("logs", []):
            index, field = entry["index"], entry["field"]
            log = (self.api.executor.translate.columns(index)
                   if field is None
                   else self.api.executor.translate.rows(index, field))
            try:
                self._pull_log_tail(seed, index, field, log)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("translate pull %s/%s failed: %s",
                                    index, field, e)

    def keys_of(self, index: str, field: str | None, ids) -> list[str]:
        log = (self.api.executor.translate.columns(index) if field is None
               else self.api.executor.translate.rows(index, field))
        out, missing = [], False
        for i in ids:
            k = log.key_of(int(i))
            if k is None:
                missing = True
                break
            out.append(k)
        if not missing:
            return out
        self._sync_log_from_coordinator(index, field, log)
        return [log.key_of(int(i)) or f"<unknown:{i}>" for i in ids]

    # -- anti-entropy (reference: holder syncer, SURVEY.md §4.6) ------------

    def _aae_loop(self) -> None:
        while not self._stop.wait(self.cfg.anti_entropy_interval):
            try:
                self.sync_once()
            except Exception as e:  # noqa: BLE001
                self.logger.warning("anti-entropy round failed: %s", e)

    def sync_once(self, scope: tuple | None = None) -> int:
        """One AAE round: for every local fragment replicated elsewhere,
        diff block checksums with each replica and union-merge
        differences both ways.  Returns blocks repaired.

        ``scope`` ``(index, field, view, shard)``, each None for any,
        limits the round to the fragments it names (and skips the
        attribute stores): a triggered repair of known fragments need
        not checksum every fragment of the node.

        Hinted-handoff ordering rule: any sync with a peer that
        has pending hinted writes anywhere in the cluster is DEFERRED
        — its copies are stale until the ordered replay lands, and a
        union-merge now could resurrect a Clear the replay is about to
        deliver.  A node finding ITSELF hinted sits the round out for
        the same reason."""
        repaired = 0
        deferred = 0
        hinted = self.hinted_peers()
        if self.node_id in hinted:
            self.logger.info("anti-entropy deferred: hinted writes "
                             "pending for this node (replay first)")
            self.stats.count("aae_hint_deferred_total", 1)
            return 0
        holder = self.api.holder
        storage_health = getattr(holder, "storage_health", None)
        want = scope or (None, None, None, None)
        for iname, idx in list(holder.indexes.items()):
            for fname, f in list(idx.fields.items()):
                for vname, v in list(f.views.items()):
                    for shard, frag in list(v.fragments.items()):
                        if any(w is not None and w != got for w, got in
                               zip(want, (iname, fname, vname, shard))):
                            continue
                        if storage_health is not None \
                                and storage_health.is_quarantined(
                                    frag.path):
                            # quarantined: this copy is
                            # untrustworthy — pushing its blocks would
                            # spread the corruption; replica repair
                            # owns it, AAE resumes after un-quarantine
                            deferred += 1
                            continue
                        owners = self.shard_owners(iname, shard)
                        if self.node_id not in owners:
                            # ORPHAN: we hold a fragment the active
                            # topology doesn't assign us (e.g. a Set
                            # that landed here mid-resize, just before
                            # the placement flipped).  Hand
                            # the bits to every alive owner, then drop
                            # our copy so the handoff is one-time.
                            if hinted & set(owners):
                                deferred += 1
                                continue
                            repaired += self._handoff_orphan(
                                iname, fname, vname, shard, frag, v,
                                owners)
                            continue
                        for peer in owners:
                            if peer == self.node_id:
                                continue
                            if peer in hinted:
                                deferred += 1
                                continue
                            repaired += self._sync_fragment(
                                peer, iname, fname, vname, shard, frag)
        if scope is None:
            repaired += self._sync_attrs(exclude=hinted)
        if deferred:
            self.stats.count("aae_hint_deferred_total", deferred)
        if repaired:
            self.logger.info("anti-entropy repaired %d blocks", repaired)
            self.stats.count("aae_blocks_repaired", repaired)
        return repaired

    def _handoff_orphan(self, index: str, field: str, view: str,
                        shard: int, frag, view_obj, owners) -> int:
        """Union-merge an un-owned local fragment into EVERY alive
        owner, then delete the local copy (only if all owners took it —
        a failed push keeps the orphan for the next round).

        Two  fixes: (1) the fragment's generation is
        re-checked UNDER ITS LOCK before the delete — bits written
        between the push snapshot and the delete (a Set routed here by
        a peer with stale placement) trigger a re-push instead of
        being permanently lost; (2) EMPTY orphans are deleted instead
        of being re-scanned every AAE round forever.

        Deletion runs under the VIEW lock (then the fragment lock —
        the same view→fragment order the store uses): pop, close, AND
        unlink together, so a concurrent ``view.fragment(create=True)``
        cannot recreate the fragment at the same path between the pop
        and the unlink and have its fresh files unlinked from under it
        (that write would vanish on restart with no AAE record)."""
        import os

        def _delete_local(check) -> bool:
            """Atomically (view lock → frag lock) re-check ``check``,
            then pop + close + unlink.  False = re-check failed."""
            with view_obj._lock:
                with frag.lock:
                    if not check():
                        return False
                    view_obj.fragments.pop(shard, None)
                    path = frag.path
                    frag.close()
                    for suffix in ("", ".oplog", ".dense"):
                        try:
                            os.remove(path + suffix)
                        except OSError:
                            pass
            return True

        if self.state != STATE_NORMAL:
            return 0  # mid-resize: the job itself is moving fragments
        if not frag.row_ids():
            # empty orphan: drop it now (emptiness re-checked under the
            # locks — a write may have landed since the check above)
            if _delete_local(lambda: not frag.row_ids()):
                self.logger.info(
                    "empty orphan fragment %s/%s/%s/%d deleted",
                    index, field, view, shard)
            return 0
        alive = set(self.alive_ids())
        if not all(o in alive for o in owners):
            return 0  # can't guarantee full handoff; retry next round
        for _attempt in range(3):
            gen = frag.generation
            try:
                for dest in owners:
                    self.push_fragment(index, field, view, shard, dest)
            except Exception as e:  # noqa: BLE001 — keep orphan, retry
                self.logger.warning("orphan handoff %s/%s/%s/%d: %s",
                                    index, field, view, shard, e)
                return 0
            if _delete_local(lambda: frag.generation == gen):
                self.logger.info(
                    "orphan fragment %s/%s/%s/%d handed to %s",
                    index, field, view, shard, owners)
                return 1
            # mutated during the push: those bits are not in the
            # snapshot we shipped — push again before deleting
        return 0  # kept hot by writers; next AAE round retries

    def _sync_attrs(self, exclude: set | frozenset = frozenset()) -> int:
        """AAE for attribute stores (reference: AttrStore block sync,
        SURVEY.md §4.6).  Attr stores are fully replicated: diff with
        every alive peer, merge differing blocks both ways.
        ``exclude``: hinted peers — their attr state is stale until
        the ordered replay lands (same deferral rule as fragments)."""
        repaired = 0
        holder = self.api.holder
        targets: list[tuple[str, str]] = []  # (index, field-or-"")
        for iname, idx in list(holder.indexes.items()):
            if os.path.exists(os.path.join(idx.path, "_attrs.db")):
                targets.append((iname, ""))
            for fname, f in list(idx.fields.items()):
                if os.path.exists(os.path.join(f.path, "_attrs.db")):
                    targets.append((iname, fname))
        for iname, fname in targets:
            idx = holder.index(iname)
            store = (idx.field(fname).row_attrs if fname
                     else idx.column_attrs)
            qs = f"index={iname}&field={fname}"
            for peer in self.alive_ids():
                if peer == self.node_id or peer in exclude:
                    continue
                try:
                    theirs = self._client(peer)._json(
                        "GET", f"/internal/attrs/blocks?{qs}")["blocks"]
                except Exception:  # noqa: BLE001 — peer down
                    continue
                theirs = {int(k): v for k, v in theirs.items()}
                ours = store.blocks()
                for block in sorted(b for b in set(ours) | set(theirs)
                                    if ours.get(b) != theirs.get(b)):
                    try:
                        items = self._client(peer)._json(
                            "GET", f"/internal/attrs/block?{qs}"
                            f"&block={block}")["items"]
                        store.merge_items({int(k): v
                                           for k, v in items.items()})
                        mine = store.block_items(block)
                        self._client(peer)._json(
                            "POST", f"/internal/attrs/merge?{qs}",
                            {"items": {str(k): v
                                       for k, v in mine.items()}})
                        repaired += 1
                    except Exception as e:  # noqa: BLE001
                        self.logger.warning("attr aae %s/%s block %d: %s",
                                            iname, fname, block, e)
        return repaired

    def _sync_fragment(self, peer: str, index: str, field: str, view: str,
                       shard: int, frag) -> int:
        from pilosa_tpu_torch.api.client import ClientError
        from pilosa_tpu_torch.store import roaring
        qs = f"index={index}&field={field}&view={view}&shard={shard}"
        try:
            theirs = self._client(peer)._json(
                "GET", f"/internal/fragment/blocks?{qs}")["blocks"]
        except ClientError as e:
            if e.status == 404:
                # peer lost the whole fragment (or never had it): that
                # is maximal divergence, not "peer down" — diff against
                # empty so every block streams over
                theirs = {}
            else:
                return 0  # transport trouble; next round
        except Exception:  # noqa: BLE001 — peer down; next round
            return 0
        theirs = {int(k): v for k, v in theirs.items()}
        ours = frag.blocks()
        diff = [b for b in set(ours) | set(theirs)
                if ours.get(b) != theirs.get(b)]
        repaired = 0
        for block in sorted(diff):
            try:
                if block in theirs:
                    blob = self._client(peer)._do(
                        "GET",
                        f"/internal/fragment/data?{qs}&block={block}")
                    frag.merge_positions(roaring.deserialize(blob))
                mine = roaring.serialize(frag.block_positions(block))
                self._client(peer)._do(
                    "POST", f"/internal/fragment/merge?{qs}", mine,
                    content_type="application/octet-stream")
                repaired += 1
            except ClientError as e:
                if e.status == 409:
                    # hint-gated on the receiver (pending hinted
                    # writes cover the fragment): quietly defer the
                    # whole fragment to the post-drain round
                    return repaired
                self.logger.warning("aae %s/%s/%s/%d block %d: %s",
                                    index, field, view, shard, block, e)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("aae %s/%s/%s/%d block %d: %s",
                                    index, field, view, shard, block, e)
        return repaired

    # -- resize (reference: ResizeJob, SURVEY.md §3.3) ----------------------

    def trigger_resize(self) -> None:
        """Spawn a background rebalance (coordinator only).  Any
        in-flight job is ABORTED first (reference: ``ResizeJob`` abort on
        superseding node events) — it stops at the next fragment-copy
        boundary; the new job recomputes against current membership, so
        partial copies are never lost, only re-planned."""
        self._resize_abort.set()
        self._spawn(self._resize_job, "resize")

    def abort_resize(self) -> None:
        """Abort an in-flight rebalance at the next copy boundary."""
        self._resize_abort.set()

    # -- explicit removal (reference: remove-node resize, SURVEY.md §6) -----

    def remove_node(self, node_id: str) -> None:
        """Coordinator: remove a node from membership (dead or retiring),
        tombstone it, broadcast the removal, and rebalance so remaining
        replicas restore the replication factor."""
        if not self.is_coordinator():
            raise PermissionError(
                f"not the coordinator (coordinator is "
                f"{self.coordinator_id()})")
        if node_id == self.node_id:
            raise ValueError("coordinator cannot remove itself")
        with self._lock:
            if node_id not in self.nodes:
                raise KeyError(node_id)
            del self.nodes[node_id]
            self._last_seen.pop(node_id, None)
            self._removed[node_id] = time.time()
        payload = {"id": node_id, "ts": time.time()}
        for nid in self.member_ids():
            if nid == self.node_id:
                continue
            try:
                self._client(nid)._json("POST", "/internal/node/remove",
                                        payload)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("remove broadcast to %s failed: %s",
                                    nid, e)
        self.logger.info("removed node %s; rebalancing", node_id)
        self.trigger_resize()

    def handle_node_remove(self, payload: dict) -> None:
        with self._lock:
            self.nodes.pop(payload["id"], None)
            self._last_seen.pop(payload["id"], None)
            self._removed[payload["id"]] = payload.get("ts", time.time())

    def _resize_job(self) -> None:
        """Coordinator: rebalance fragments onto the current membership.
        Gather inventories, compute transfers, instruct sources to push.
        Jobs serialize on ``_resize_lock``; the cluster always lands on
        NORMAL afterwards."""
        with self._resize_lock:
            self._resize_abort.clear()
            self._resize_once()

    def _resize_once(self) -> None:
        with self._lock:
            self.state = STATE_RESIZING
            target = self.member_ids()
        self._broadcast_status()
        completed = False
        try:
            inventory: dict[tuple, list[str]] = {}
            for nid in self.alive_ids():
                try:
                    frags = (self._local_inventory()
                             if nid == self.node_id else
                             self._client(nid)._json(
                                 "GET", "/internal/fragments")["fragments"])
                except Exception as e:  # noqa: BLE001
                    self.logger.warning("inventory from %s failed: %s",
                                        nid, e)
                    continue
                for fr in frags:
                    key = (fr["index"], fr["field"], fr["view"], fr["shard"])
                    inventory.setdefault(key, []).append(nid)
            moved = 0
            for (index, field, view, shard), holders in inventory.items():
                if self._resize_abort.is_set():
                    self.logger.info(
                        "resize aborted after %d copies (superseded)",
                        moved)
                    return
                owners = shard_nodes(index, shard, target,
                                     self.cfg.replicas)
                for dest in owners:
                    if dest in holders:
                        continue
                    src = holders[0]
                    try:
                        if src == self.node_id:
                            self.push_fragment(index, field, view, shard,
                                               dest)
                        else:
                            self._client(src)._json(
                                "POST", "/internal/resize/push",
                                {"index": index, "field": field,
                                 "view": view, "shard": shard,
                                 "dest": dest})
                        moved += 1
                    except Exception as e:  # noqa: BLE001
                        self.logger.warning("resize push %s -> %s: %s",
                                            (index, field, view, shard),
                                            dest, e)
            self.logger.info("resize complete: %d fragment copies moved",
                             moved)
            completed = True
        finally:
            with self._lock:
                self.state = STATE_NORMAL
                if completed:
                    # every copy for the target topology is streamed:
                    # activate it (and broadcast) so reads start
                    # routing to the new owners.  The version rides
                    # every heartbeat, so a peer that misses this
                    # broadcast still converges (pull-on-mismatch).
                    # max(now, prev+1): a coordinator whose wall clock
                    # trails the previous coordinator's must still mint
                    # a STRICTLY newer version, or peers would reject
                    # (and pull back over) the new topology
                    self.placement_ids = list(target)
                    self.placement_version = max(
                        time.time(), self.placement_version + 1.0)
                    self._save_placement()
            self._broadcast_status()

    def _local_inventory(self) -> list[dict]:
        out = []
        for iname, idx in self.api.holder.indexes.items():
            for fname, f in idx.fields.items():
                for vname, v in f.views.items():
                    for shard, frag in v.fragments.items():
                        if frag.row_ids():
                            out.append({"index": iname, "field": fname,
                                        "view": vname, "shard": shard})
        return out

    def push_fragment(self, index: str, field: str, view: str, shard: int,
                      dest: str) -> None:
        """Send one local fragment's bits to ``dest`` (union-merge
        there)."""
        from pilosa_tpu_torch.store import roaring
        idx = self.api.holder.index(index)
        frag = idx.field(field).view(view).fragment(shard)
        sh = getattr(self.api.holder, "storage_health", None)
        if sh is not None and sh.is_quarantined(frag.path):
            # a resize/orphan push from a corrupt copy would spread
            # the corruption to the new owner — refuse loudly (the
            # resize job logs and retries after repair)
            raise RuntimeError(
                f"fragment {frag.path} is quarantined (storage "
                "corruption); not pushing until repaired")
        blob = roaring.serialize(frag.positions())
        qs = f"index={index}&field={field}&view={view}&shard={shard}"
        self._client(dest)._do(
            "POST", f"/internal/fragment/merge?{qs}", blob,
            content_type="application/octet-stream")

    # -- quarantine repair (storage integrity) ---------------------------------

    def repair_quarantined(self, entry: dict) -> bool:
        """Replica repair for one quarantined fragment (the scrubber's
        ``on_corrupt`` hook): pull a healthy replica's FULL position
        set over the AAE data path, rebuild the local fragment
        wholesale (fresh framed snapshot, truncated op-log), re-verify
        the new bytes, un-quarantine.  While this runs, reads keep
        serving from the replica (``group_shards_by_node`` routes
        around us) and local writes keep refusing — the replica's copy
        therefore includes every write accepted during quarantine, so
        the rebuild loses nothing.  Returns True when repaired; a
        False (no live replica, pull failed, disk still refusing)
        leaves the quarantine in place for the next scrub pass."""
        from pilosa_tpu_torch.store import roaring as _roaring
        from pilosa_tpu_torch.store import scrub as _scrub
        sh = getattr(self.api.holder, "storage_health", None)
        key = entry.get("key")
        if sh is None or key is None:
            return False  # not a fragment of this tree
        index, field, view, shard = key
        idx = self.api.holder.index(index)
        fld = idx.field(field) if idx is not None else None
        vw = fld.view(view) if fld is not None else None
        frag = vw.fragment(shard) if vw is not None else None
        if frag is None:
            # the fragment no longer exists (index/field deleted):
            # nothing to repair, drop the stale quarantine entry
            sh.unquarantine(entry["path"])
            return True
        alive = set(self.alive_ids())
        sources = [o for o in self.shard_owners(index, shard)
                   if o != self.node_id and o in alive]
        # breaker-closed replicas first; open peers stay a last resort
        sources.sort(key=lambda o: self.breakers.state(o) != "closed")
        qs = (f"index={index}&field={field}&view={view}"
              f"&shard={shard}")
        for src in sources:
            try:
                blob = self._client(src)._do(
                    "GET", f"/internal/fragment/data?{qs}")
                positions = _roaring.deserialize(blob)
            except Exception as e:  # noqa: BLE001 — try the next replica
                self.logger.warning(
                    "storage repair: pull %s/%s/%s/%d from %s failed: "
                    "%s", index, field, view, shard, src, e)
                continue
            try:
                frag.rebuild_from_positions(positions)
            except OSError as e:
                self.logger.error(
                    "storage repair: rebuild of %s failed on disk: %s "
                    "(quarantine stays; next scrub pass retries)",
                    frag.path, e)
                return False
            problems, _ = _scrub.verify_fragment(frag)
            if problems is None or problems:
                # None = no verdict (the scan raced a file change) —
                # un-quarantining on anything short of a VERIFIED
                # clean read would put unconfirmed bytes back into
                # service; the quarantine stays and the next scrub
                # pass retries the repair
                self.logger.error(
                    "storage repair: REBUILT fragment %s did not "
                    "verify clean (%s) — quarantine stays; next scrub "
                    "pass retries", frag.path,
                    "no verdict" if problems is None else problems)
                return False
            sh.unquarantine(frag.path)
            sh.note_repair(frag.path, source=src)
            self.logger.info(
                "storage repair: fragment %s/%s/%s/%d rebuilt from "
                "replica %s (%d positions) and re-verified",
                index, field, view, shard, src, len(positions))
            return True
        self.logger.warning(
            "storage repair: no live replica for quarantined "
            "%s/%s/%s/%d (owners %s); retrying next scrub pass",
            index, field, view, shard,
            self.shard_owners(index, shard))
        return False

    # -- observability fan-in (the single-pane cluster view) -----------------

    # per-peer budget for one observability fetch: a scrape of the
    # whole fleet must finish inside a Prometheus scrape interval even
    # when one peer is wedged mid-crash (the fetches run concurrently,
    # so this bounds the WHOLE fan-in, not N× it)
    OBS_FANIN_TIMEOUT = 2.0

    def _obs_fanin(self, fetch) -> tuple[dict[str, dict], list[str]]:
        """Breaker-aware concurrent fan-out of one observability fetch
        per peer; returns ``({node_id: payload}, [stale node ids])``.

        Partial-result contract: a suspect member, an open-breaker
        peer, a failed fetch, or a fetch still running at the overall
        deadline lands the node on the ``stale`` list — never an
        error, and never a probe.  Scrapes OBSERVE the fleet; they
        must not perturb routing, so outcomes here deliberately stay
        out of the breaker accounting (a monitoring burst against a
        half-open peer must not flap reads).

        Each fetch thread writes ONLY its own slot dict: the client
        timeout is per socket operation, not a deadline (connect +
        read + an idempotent-GET retry can outlive the join budget),
        so a thread may finish AFTER this method returned — a shared
        dict would then mutate under the caller's render iteration.
        Threads alive at the deadline are reported stale and their
        late result is simply never read."""
        alive = set(self.alive_ids())
        peers = [nid for nid in self.member_ids() if nid != self.node_id]

        def one(nid: str, slot: dict) -> None:
            if nid not in alive or self.breakers.state(nid) == "open":
                return  # empty slot = stale
            try:
                slot["payload"] = fetch(self._client(nid))
            except Exception:  # noqa: BLE001 — degraded, never an error
                pass

        slots = [(nid, {}) for nid in peers]
        threads = [threading.Thread(target=one, args=(nid, slot),
                                    name="pilosa-obs-fanin", daemon=True)
                   for nid, slot in slots]
        for t in threads:
            t.start()
        # one overall deadline (not per-thread): a scrape of the whole
        # fleet must finish inside a Prometheus scrape interval even
        # when several peers are wedged mid-crash
        deadline = time.monotonic() + self.OBS_FANIN_TIMEOUT + 1.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        results: dict[str, dict] = {}
        stale: list[str] = []
        for (nid, slot), t in zip(slots, threads):
            payload = None if t.is_alive() else slot.get("payload")
            if payload is None:
                stale.append(nid)
            else:
                results[nid] = payload
        return results, sorted(stale)

    def metrics_snapshots(self) -> tuple[dict[str, dict], list[str]]:
        """Per-peer :meth:`pilosa_tpu_torch.obs.metrics.Stats.full_snapshot`
        payloads for the ``GET /metrics/cluster`` fan-in (the caller
        adds its own local snapshot after refreshing scrape-time
        gauges)."""
        return self._obs_fanin(
            lambda client: client._do(
                "GET", "/internal/metrics/snapshot",
                timeout=self.OBS_FANIN_TIMEOUT)["snapshot"])

    def status_snapshots(self) -> tuple[dict[str, dict], list[str]]:
        """Per-peer ``/status`` payloads for ``GET /status/cluster``."""
        return self._obs_fanin(
            lambda client: client._do("GET", "/status",
                                      timeout=self.OBS_FANIN_TIMEOUT))

    def flight_snapshots(self, limit: int = 0) \
            -> tuple[dict[str, dict], list[str]]:
        """Per-peer ``/debug/flight`` payloads: one call pulls
        every node's dispatch-lifecycle ring so a fleet-wide incident
        timeline can be assembled without shelling into each box."""
        path = "/debug/flight" + (f"?limit={int(limit)}" if limit else "")
        return self._obs_fanin(
            lambda client: client._do("GET", path,
                                      timeout=self.OBS_FANIN_TIMEOUT))

    # -- introspection -------------------------------------------------------

    def health_payload(self) -> dict:
        """The ``clusterHealth`` block on ``/status``: per-peer
        last-seen age, suspect verdict, and breaker state — what an
        operator needs to see why reads are (or are not) detouring."""
        alive = set(self.alive_ids())
        now = time.monotonic()
        horizon = SUSPECT_AFTER * self.cfg.heartbeat_interval
        with self._lock:
            members = sorted(self.nodes)
            seen = dict(self._last_seen)
        peers = []
        for nid in members:
            if nid == self.node_id:
                continue
            age = (now - seen[nid]) if nid in seen else None
            peers.append({
                "id": nid,
                "lastSeenAgeSeconds": (round(age, 3)
                                       if age is not None else None),
                "suspect": nid not in alive,
                "breaker": self.breakers.state(nid)})
        return {"suspectAfterSeconds": horizon, "peers": peers}

    def nodes_status(self) -> list[dict]:
        alive = set(self.alive_ids())
        coord = self.coordinator_id()
        return [{"id": nid, "uri": n["uri"],
                 "state": (n.get("state", STATE_NORMAL)
                           if nid in alive else "DOWN"),
                 "isPrimary": nid == coord}
                for nid, n in sorted(self.nodes.items())]
