"""Chaos harness (``pilosa_tpu.fault.chaos``'s): scripted fault schedules
against the OS-process cluster, with an in-memory oracle and invariant
checks.

The distributed claims of the cluster (anti-entropy union-merge,
versioned placement with pull-on-mismatch, orphan handoff, CRC-framed
oplog replay, idempotent internode retry) are exercised here under
injected failure, not just on the happy path:

====================================  ==================================
scenario                              invariant asserted after faults
                                      clear
====================================  ==================================
partition_during_resize               no acked write lost; queries
                                      oracle-exact on every node; AAE
                                      re-converges every replica
crash_mid_oplog_append                replay yields a clean prefix:
                                      acked writes survive a kill -9,
                                      the torn record never corrupts
duplicate_delivery                    dropped internal responses ⇒
                                      retries redeliver; bits never
                                      double-count, replicas converge
dropped_placement_broadcast           a dropped resize-completion
                                      broadcast still converges via
                                      the heartbeat placement version
dropped_internal_response_trace       a redelivered fan-out leg is
                                      visible in the profile tree
                                      (``retried`` tag) — traces
                                      never lie under failure
node_kill_failover                    kill -9 mid-serve (replicas=2,
                                      handoff disabled): zero read
                                      failures via replica failover,
                                      breaker opens, strict writes
                                      refuse 503, rejoin closes the
                                      breaker
straggler_hedged_read                 a delayed leg is hedged to a
                                      replica: bounded latency, exact
                                      answer, ``hedged`` trace tag
breaker_lifecycle                     open → half_open → closed pinned
                                      through partition + heal; open
                                      routing pays no failover tax
clear_during_kill_handoff             kill -9 mid-serve (replicas=2,
                                      handoff ON): Set/Clear/ClearRow
                                      all keep serving, rejoin drains
                                      the hint log, every node ends
                                      oracle-exact and a forced AAE
                                      round resurrects nothing
coordinator_crash_hint_log            kill -9 the write coordinator
                                      mid-hint-append (torn record):
                                      recovery truncates the torn op
                                      (it never applies anywhere) and
                                      replays the clean prefix
hung_dispatch_serving                 a hung device dispatch on one
                                      plane: unaffected queries keep
                                      answering exact (availability
                                      1.0), the wedged caller gets a
                                      structured 504/500 naming the
                                      stage, the governor probes back
                                      to healthy, zero leaked threads
flaky_device_governor                 consecutive dispatch faults:
                                      at most ``times`` callers get
                                      the 500 naming the fault, every
                                      other answer is exact, the
                                      governor degrades then probes
                                      back to healthy
corrupt_fragment_scrub_repair         a byte-flipped snapshot: the
                                      scrubber detects it, reads stay
                                      exact through replica failover,
                                      the fragment repairs from its
                                      replica, forced AAE finds no
                                      divergence
disk_full_during_ingest               ENOSPC mid-import: the node turns
                                      read-only with structured 507s,
                                      batches keep acking through hints,
                                      freed space restores it and the
                                      drain lands exact
bulk_import_kill_handoff              kill -9 mid-bulk-import: batches
                                      keep acking as import hints, the
                                      drain replays them, op-id dedup
                                      no-ops a redelivery
====================================  ==================================

Two scenarios differ from the reference's where the port's dispatch
pipeline does (``ROADMAP.md``, "Pinned"): ``flaky_device_governor`` (a
failing launch raises to its callers instead of falling back item by
item) and ``hung_dispatch_serving`` (a quarantined window keeps its
operands until its CUDA event completes, and the port's pipeline threads
have the port's names).  Each says so in its docstring.

Oracle semantics are at-least-once honest: a write the harness saw FAIL
may still have applied on some replica (lost response, torn tail after
the memory mutation).  The standing bar — "no lost acknowledged
writes" — is therefore checked as ``acked ⊆ observed ⊆ attempted``;
observed bits outside ``attempted`` are corruption and fail loudly.
Clears sharpen it: ``observed ∩ cleared = ∅`` — an acked Clear
not re-attempted since must stay absent on every node, forever; a bit
resurrected by anti-entropy is the loudest possible failure.

Every schedule is reproducible: all randomness (write placement, fault
parameters, drop probabilities) flows from one printed seed.

Runbook: ``python -m pilosa_tpu_torch.fault.chaos [--seed N] [--scenario
S] [--device cpu]`` boots its own process clusters in a temp dir, on the
CUDA device unless ``--device`` names another; ``tests/test_torch_chaos*.py``
drive the same scenarios on the CPU.
"""

from __future__ import annotations

import os
import random
import time

from pilosa_tpu_torch.api.client import Client, ClientError
from pilosa_tpu_torch.engine.words import SHARD_WIDTH


class InvariantViolation(AssertionError):
    """A chaos invariant failed; the message carries the seed."""


def prom_counter_total(text: str, name: str) -> float:
    """Sum one counter family across its labels from Prometheus
    exposition text (shared by the harness and bench/config22)."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name) and line[len(name)] in "{ ":
            total += float(line.rsplit(" ", 1)[1])
    return total


class ChaosHarness:
    """One scenario's state: a process cluster, a seeded RNG, and the
    acked/attempted write oracle."""

    N_ROWS = 3
    MAX_COL = 3 * SHARD_WIDTH - 1  # spread writes over ~3 shards

    def __init__(self, cluster, seed: int, index: str, field: str = "f"):
        self.cluster = cluster
        self.seed = seed
        self.rng = random.Random(seed)
        self.index, self.field = index, field
        self.acked: dict[int, set[int]] = {}
        self.attempted: dict[int, set[int]] = {}
        # bits whose Clear was ACKED and not re-attempted since: they
        # must be absent on every node once hints drain — the
        # resurrection oracle for the handoff scenarios
        self.cleared: dict[int, set[int]] = {}
        print(f"[chaos] scenario index={index!r} seed={seed}", flush=True)

    def _fail(self, msg: str) -> "InvariantViolation":
        return InvariantViolation(
            f"{msg} (reproduce with seed={self.seed})")

    def client(self, i: int = 0) -> Client:
        return self.cluster.client(i)

    @property
    def n(self) -> int:
        return len(self.cluster.nodes)

    # -- fault control -------------------------------------------------------

    def set_fault(self, node_i: int, site: str, action: str, **kw) -> dict:
        return self.client(node_i)._json(
            "POST", "/internal/fault",
            {"site": site, "action": action, **kw})

    def clear_faults(self) -> None:
        for i in range(self.n):
            try:
                self.client(i)._json("POST", "/internal/fault/clear", {})
            except (ClientError, OSError):
                pass  # node mid-restart; its registry died with it

    def partition(self, i: int, j: int) -> None:
        """Sever the (i, j) node pair in both directions — each side's
        outbound requests to the other fail as connection-refused."""
        peer_j = f"127.0.0.1:{self.cluster.nodes[j].port}"
        peer_i = f"127.0.0.1:{self.cluster.nodes[i].port}"
        self.set_fault(i, "client.send", "partition",
                       match={"peer": peer_j})
        self.set_fault(j, "client.send", "partition",
                       match={"peer": peer_i})

    # -- cluster introspection ----------------------------------------------

    def node_id(self, i: int) -> str:
        return f"127.0.0.1:{self.cluster.nodes[i].port}"

    def breaker_state(self, via: int, peer_id: str) -> str | None:
        """Peer breaker state as node ``via`` reports it on the
        ``/status`` clusterHealth block."""
        st = self.client(via)._json("GET", "/status")
        for p in st.get("clusterHealth", {}).get("peers", []):
            if p["id"] == peer_id:
                return p["breaker"]
        return None

    def counter_total(self, via: int, name: str) -> float:
        """Sum a counter family across labels from ``/metrics``."""
        return prom_counter_total(self.client(via).metrics_text(), name)

    def await_hints_drained(self, via: int, timeout: float = 40.0) -> None:
        """Poll ``writeHealth`` on node ``via`` until its hint backlog
        is empty (the rejoined peer has replayed every queued op)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if not self.client(via).write_health().get(
                        "hintBacklogOps"):
                    return
            except (ClientError, OSError):
                pass
            time.sleep(0.3)
        raise self._fail("hint backlog never drained")

    def coordinator_index(self) -> int:
        status = self.client(0)._json("GET", "/status")
        primary = next(nd["id"] for nd in status["nodes"]
                       if nd.get("isPrimary"))
        port = int(primary.rsplit(":", 1)[1])
        for i, node in enumerate(self.cluster.nodes):
            if node.port == port:
                return i
        raise self._fail(f"coordinator {primary} is not in the harness")

    def placement_versions(self) -> list[float]:
        return [float(self.client(i)._json(
            "GET", "/internal/cluster/state")["placementVersion"])
            for i in range(self.n)]

    def await_all_normal(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if all(self.client(i)._json("GET", "/status")["state"]
                       == "NORMAL" for i in range(self.n)):
                    return
            except (ClientError, OSError):
                pass
            time.sleep(0.3)
        raise self._fail("cluster never returned to NORMAL")

    def await_coordinator_normal(self, timeout: float = 60.0) -> None:
        """NORMAL on the coordinator only — mid-partition, suspect
        peers legitimately report DEGRADED."""
        deadline = time.monotonic() + timeout
        coord = self.coordinator_index()
        while time.monotonic() < deadline:
            try:
                if (self.client(coord)._json("GET", "/status")["state"]
                        == "NORMAL"):
                    return
            except (ClientError, OSError):
                pass
            time.sleep(0.3)
        raise self._fail("coordinator never finished the resize")

    # -- workload ------------------------------------------------------------

    def setup(self) -> None:
        c = self.client(0)
        c.create_index(self.index)
        c.create_field(self.index, self.field)

    def write(self, row: int, col: int, via: int = 0) -> bool:
        """One ``Set``; records the attempt, and the ack only when the
        cluster answered 200.  A failed write may still have applied on
        some replica (at-least-once) — that is what ``attempted``
        captures.  The ATTEMPT also lifts the bit's cleared-ness: a
        Set racing an earlier acked Clear may legitimately re-appear."""
        self.attempted.setdefault(row, set()).add(col)
        self.cleared.setdefault(row, set()).discard(col)
        try:
            self.client(via).query(self.index,
                                   f"Set({col}, {self.field}={row})")
        except (ClientError, OSError):
            return False
        self.acked.setdefault(row, set()).add(col)
        return True

    def clear(self, row: int, col: int, via: int = 0) -> bool:
        """One ``Clear``.  The ATTEMPT removes the bit from ``acked``
        (a failed clear may still have applied — state unknown); an
        acked clear moves it to ``cleared``: the bit must be absent on
        every node once hints drain, and must NEVER be resurrected by
        anti-entropy."""
        self.acked.setdefault(row, set()).discard(col)
        try:
            self.client(via).query(self.index,
                                   f"Clear({col}, {self.field}={row})")
        except (ClientError, OSError):
            return False
        self.attempted.setdefault(row, set()).discard(col)
        self.cleared.setdefault(row, set()).add(col)
        return True

    def clear_row(self, row: int, via: int = 0) -> bool:
        """One ``ClearRow``; on ack, every bit the row might hold
        becomes cleared-and-must-stay-absent (until re-set)."""
        self.acked[row] = set()
        try:
            self.client(via).query(self.index,
                                   f"ClearRow({self.field}={row})")
        except (ClientError, OSError):
            return False
        self.cleared.setdefault(row, set()).update(
            self.attempted.get(row, set()))
        self.attempted[row] = set()
        return True

    def random_writes(self, count: int, via: int = 0) -> int:
        acked = 0
        for _ in range(count):
            row = self.rng.randrange(self.N_ROWS)
            col = self.rng.randrange(self.MAX_COL)
            acked += bool(self.write(row, col, via=via))
        return acked

    def bulk_import(self, pairs, via: int = 0,
                    clear: bool = False) -> bool:
        """One bulk-import batch: all pairs in ONE request over
        the pair-import endpoint.  Oracle updates mirror
        :meth:`write`/:meth:`clear` per pair — a failed batch may have
        partially applied (per-shard commits), which ``attempted``
        absorbs."""
        for r, c in pairs:
            if clear:
                self.acked.setdefault(r, set()).discard(c)
            else:
                self.attempted.setdefault(r, set()).add(c)
                self.cleared.setdefault(r, set()).discard(c)
        try:
            self.client(via)._json(
                "POST", f"/index/{self.index}/field/{self.field}/import",
                {"rowIDs": [int(r) for r, _ in pairs],
                 "columnIDs": [int(c) for _, c in pairs],
                 "clear": clear})
        except (ClientError, OSError):
            return False
        for r, c in pairs:
            if clear:
                self.attempted.setdefault(r, set()).discard(c)
                self.cleared.setdefault(r, set()).add(c)
            else:
                self.acked.setdefault(r, set()).add(c)
        return True

    # -- invariants ----------------------------------------------------------

    def check_oracle(self, via: int | None = None) -> None:
        """Every node's answer for every row satisfies
        ``acked ⊆ observed ⊆ attempted`` and ``observed ∩ cleared = ∅``
        (and Count agrees with Row) — acked writes are never lost,
        nothing appears that was never written (corruption / replayed
        half-records), and an acked clear is never resurrected."""
        nodes = [via] if via is not None else range(self.n)
        for i in nodes:
            c = self.client(i)
            for row in range(self.N_ROWS):
                res = c.query(
                    self.index,
                    f"Row({self.field}={row})"
                    f"Count(Row({self.field}={row}))")
                got = set(res[0]["columns"])
                count = res[1]
                acked = self.acked.get(row, set())
                attempted = self.attempted.get(row, set())
                cleared = self.cleared.get(row, set())
                if not acked <= got:
                    raise self._fail(
                        f"node {i} row {row}: LOST acked writes "
                        f"{sorted(acked - got)[:10]}")
                if got & cleared:
                    raise self._fail(
                        f"node {i} row {row}: RESURRECTED cleared bits "
                        f"{sorted(got & cleared)[:10]}")
                if not got <= attempted:
                    raise self._fail(
                        f"node {i} row {row}: phantom bits "
                        f"{sorted(got - attempted)[:10]} never written")
                if count != len(got):
                    raise self._fail(
                        f"node {i} row {row}: Count={count} but "
                        f"Row has {len(got)} columns")

    def await_oracle(self, timeout: float = 90.0) -> None:
        """Poll until every node answers oracle-consistently (AAE has
        repaired what the faults diverged)."""
        deadline = time.monotonic() + timeout
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                self.check_oracle()
                return
            except (InvariantViolation, ClientError, OSError) as e:
                last = e
            time.sleep(0.5)
        raise self._fail(f"oracle never converged: {last}")

    def await_replica_convergence(self, expected_holders: int,
                                  timeout: float = 90.0) -> None:
        """AAE/handoff end state: every fragment is held by exactly
        ``expected_holders`` nodes (orphans handed off and deleted,
        missing replicas re-filled) and all holders' position sets are
        byte-identical."""
        deadline = time.monotonic() + timeout
        last = "no fragments observed"
        while time.monotonic() < deadline:
            try:
                problem = self._replica_divergence(expected_holders)
            except (ClientError, OSError) as e:
                problem = f"transport: {e}"
            if problem is None:
                return
            last = problem
            time.sleep(0.7)
        raise self._fail(f"replicas never converged: {last}")

    def _replica_divergence(self, expected_holders: int) -> str | None:
        datas: dict[tuple, dict[int, bytes]] = {}
        for i in range(self.n):
            inv = self.client(i)._json(
                "GET", "/internal/fragments")["fragments"]
            for fr in inv:
                if fr["index"] != self.index:
                    continue  # other scenarios' data is not ours to judge
                key = (fr["index"], fr["field"], fr["view"], fr["shard"])
                qs = (f"index={fr['index']}&field={fr['field']}"
                      f"&view={fr['view']}&shard={fr['shard']}")
                blob = self.client(i)._do(
                    "GET", f"/internal/fragment/data?{qs}")
                datas.setdefault(key, {})[i] = blob
        if not datas:
            return "no fragments observed"
        for key, per_node in datas.items():
            if len(per_node) != expected_holders:
                return (f"{key} held by {sorted(per_node)} "
                        f"(want {expected_holders} holders)")
            if len(set(per_node.values())) != 1:
                return f"{key} differs across {sorted(per_node)}"
        return None

    def await_placement_convergence(self, min_version: float,
                                    timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        last: object = None
        while time.monotonic() < deadline:
            try:
                versions = self.placement_versions()
                if (len(set(versions)) == 1
                        and versions[0] > min_version):
                    return
                last = versions
            except (ClientError, OSError) as e:
                last = e
            time.sleep(0.3)
        raise self._fail(
            f"placement never converged past {min_version}: {last}")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def scenario_partition_during_resize(cluster, seed: int) -> ChaosHarness:
    """A node pair partitions, a rebalance runs THROUGH the partition
    (its pushes to the unreachable side fail and the data stays behind
    as orphans), writes continue — after the partition heals, anti-
    entropy must hand every orphan to its owners and every node must
    answer oracle-exact."""
    h = ChaosHarness(cluster, seed, index="chaos_part")
    h.setup()
    h.random_writes(30)
    h.check_oracle()
    h.partition(1, 2)
    acked = h.random_writes(15)  # via node 0: reaches everyone
    if acked == 0:
        raise h._fail("no write acked during the partition")
    coord = h.coordinator_index()
    h.client(coord)._json("POST", "/internal/resize/trigger", {})
    time.sleep(0.5)  # let the resize thread flip into RESIZING
    h.await_coordinator_normal()
    h.random_writes(10)  # against the (possibly stale) new placement
    h.clear_faults()
    h.await_all_normal()
    h.await_oracle()
    h.await_replica_convergence(expected_holders=2)
    return h


def scenario_crash_mid_oplog_append(cluster, seed: int,
                                    tears: int = 2) -> ChaosHarness:
    """A torn oplog tail (the write 'crashes' after persisting only the
    first K bytes of the record), then a real kill -9 and restart:
    replay must recover the clean prefix — every acked write survives,
    the torn record never half-applies."""
    h = ChaosHarness(cluster, seed, index="chaos_crash")
    h.setup()
    h.random_writes(12)
    h.check_oracle()
    node = cluster.nodes[0]
    for _ in range(tears):
        # tear inside the 17-byte header or into the payload — both
        # classes must truncate cleanly on replay
        offset = h.rng.randrange(0, 25)
        h.set_fault(0, "oplog.append", "torn_write", nth=1,
                    args={"offset": offset})
        row = h.rng.randrange(h.N_ROWS)
        col = h.rng.randrange(h.MAX_COL)
        if h.write(row, col):
            raise h._fail("torn-write Set unexpectedly acked")
        node.kill9()
        node.stop()   # close the log handle; process is already dead
        node.start()
        node.await_up()
        h.await_oracle()      # replay recovered the clean prefix
        if h.random_writes(4) == 0:  # the truncated log appends again
            raise h._fail("no write acked after crash recovery")
        h.check_oracle()
    return h


def scenario_duplicate_delivery(cluster, seed: int) -> ChaosHarness:
    """A node processes internal POSTs but drops the responses
    (seeded-random, bounded): the idempotent internode retry redelivers
    every one — bits must never double-count and replicas must
    converge exactly."""
    h = ChaosHarness(cluster, seed, index="chaos_dup")
    h.setup()
    h.random_writes(10)
    h.set_fault(1, "server.response", "drop_response",
                prob=0.5, seed=seed, times=12,
                match={"path": "/internal/"})
    h.random_writes(25)
    h.clear_faults()
    h.await_oracle()
    h.await_replica_convergence(expected_holders=2)
    return h


def scenario_dropped_placement_broadcast(cluster,
                                         seed: int) -> ChaosHarness:
    """The coordinator's status broadcasts all drop (the one resize-
    completion message included): peers must still converge onto the
    new placement via the version riding every heartbeat
    (pull-on-mismatch), with the broadcasts STILL dropped."""
    h = ChaosHarness(cluster, seed, index="chaos_bcast")
    h.setup()
    h.random_writes(10)
    coord = h.coordinator_index()
    before = max(h.placement_versions())
    h.set_fault(coord, "cluster.broadcast", "drop")
    h.client(coord)._json("POST", "/internal/resize/trigger", {})
    # convergence must happen WHILE broadcasts are dropped — the
    # heartbeat version pull is the only remaining channel
    h.await_placement_convergence(min_version=before)
    h.clear_faults()
    h.await_all_normal()
    h.await_oracle()
    return h


def scenario_dropped_internal_response_trace(cluster,
                                             seed: int) -> ChaosHarness:
    """Traces must not lie under failure: a fan-out leg whose response
    is dropped (``client.recv`` failpoint — the peer answered, the
    coordinator never heard it) is transparently redelivered by the
    idempotent internode retry, and the coordinator's profile tree must
    SAY so — the grafted remote subtree carries a ``retried`` tag, the
    answer stays oracle-exact."""
    import json as _json

    h = ChaosHarness(cluster, seed, index="chaos_trace")
    h.setup()
    # row 0 populated in every shard, so any shard-restricted Count
    # has bits to count
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(10)
    h.check_oracle()
    # a remote leg must be GUARANTEED, not left to hash placement: pick
    # an entry node missing some shard and restrict the query to it
    # (with replicas < nodes such a pair always exists)
    entry = shard = None
    for i in range(h.n):
        held = h.client(i)._json(
            "GET", f"/internal/shards?index={h.index}")["shards"]
        missing = [s for s in range(3) if s not in held]
        if missing:
            entry, shard = i, missing[0]
            break
    if entry is None:
        raise h._fail("every node holds every shard; no remote leg")
    h.set_fault(entry, "client.recv", "drop", nth=1,
                match={"path": "/internal/query"})
    try:
        resp = h.client(entry)._do(
            "POST",
            f"/index/{h.index}/query?profile=true&shards={shard}",
            f"Count(Row({h.field}=0))".encode())
    finally:
        h.clear_faults()
    # the answer is still oracle-bounded (acked ⊆ observed ⊆ attempted,
    # restricted to the queried shard)
    count = resp["results"][0]
    acked = {c for c in h.acked.get(0, ()) if c // SHARD_WIDTH == shard}
    att = {c for c in h.attempted.get(0, ()) if c // SHARD_WIDTH == shard}
    if not len(acked) <= count <= len(att):
        raise h._fail(f"count {count} outside oracle "
                      f"[{len(acked)}, {len(att)}] after retry")

    def walk(span):
        yield span
        for child in span.get("children", []):
            yield from walk(child)

    spans = [s for root in resp["profile"] for s in walk(root)]
    retried = [s for s in spans if s.get("tags", {}).get("retried")]
    if not retried:
        raise h._fail(
            "trace hides the dropped-response redelivery: no span "
            f"tagged retried in {_json.dumps(resp['profile'])[:800]}")
    entry_id = f"127.0.0.1:{cluster.nodes[entry].port}"
    if not all(s["tags"].get("node") not in (None, entry_id)
               for s in retried):
        raise h._fail("retried tag landed on a non-remote span")
    h.check_oracle()
    return h


def scenario_node_kill_failover(cluster, seed: int) -> ChaosHarness:
    """kill -9 a replica-holding node MID-SERVE (replicas=2, hinted
    handoff DISABLED — the legacy strict-write pin): every read keeps
    answering oracle-exact through replica failover — zero query
    failures from the kill onward — the entry node's breaker for the
    dead peer opens (routing then skips it entirely), strict writes
    refuse loudly with the structured 503, and after a restart the
    breaker closes via heartbeat probes and every node serves again.
    Requires a cluster booted with ``PILOSA_HINT_MAX_AGE=0`` (see
    SCENARIOS) — the handoff-enabled write path has its own scenario,
    ``clear_during_kill_handoff``."""
    h = ChaosHarness(cluster, seed, index="chaos_kill")
    h.setup()
    # bits in every shard so every node's shard group is exercised
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(30)
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = next(i for i in range(h.n) if i != victim)
    victim_id = h.node_id(victim)
    cluster.nodes[victim].kill9()
    # serve THROUGH the failure: every read from the kill to past
    # breaker-open must answer, oracle-exact — zero failures allowed
    # (pre-horizon legs to the corpse fail over; post-open routing
    # skips it outright)
    deadline = time.monotonic() + 30
    reads = 0
    opened = False
    while time.monotonic() < deadline:
        try:
            h.check_oracle(via=entry)
        except InvariantViolation:
            raise
        except (ClientError, OSError) as e:
            raise h._fail(f"read failed after kill -9: {e!r}")
        reads += 1
        if h.breaker_state(entry, victim_id) == "open":
            opened = True
            break
    if not opened:
        raise h._fail(f"breaker never opened for the dead peer "
                      f"({reads} reads served)")
    if h.counter_total(entry, "read_failover_total") < 1:
        raise h._fail("no read ever failed over to a replica")
    for _ in range(5):  # breaker open: reads keep serving
        h.check_oracle(via=entry)
    # write-path strictness (handoff disabled): ClearRow touches every
    # replica including the dead one and must refuse loudly with the
    # structured 503 — never half-apply
    try:
        h.client(entry).query(h.index, f"ClearRow({h.field}=0)")
    except (ClientError, OSError) as e:
        if getattr(e, "status", 0) != 503:
            raise h._fail(f"strict write failed oddly: {e!r}")
    else:
        raise h._fail("ClearRow succeeded with a replica dead and "
                      "handoff disabled")
    h.check_oracle(via=entry)  # the refused clear mutated nothing
    # restart: the breaker must close via the heartbeat probe and the
    # node must serve its shards again
    node = cluster.nodes[victim]
    node.stop()  # reap the corpse + release the log handle
    node.start()
    node.await_up()
    cluster.await_membership(3)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if h.breaker_state(entry, victim_id) == "closed":
            break
        time.sleep(0.3)
    else:
        raise h._fail("breaker never closed after the node returned")
    h.await_oracle()  # every node (the restarted one included) exact
    return h


def scenario_straggler_hedged_read(cluster, seed: int) -> ChaosHarness:
    """A straggler leg (``dist.fanout`` delay failpoint) with hedging
    on: the entry node duplicates the leg to a live replica after
    ``hedge_after``, the first answer wins — latency stays bounded by
    the hedge, the result stays oracle-exact, and the winning subtree
    carries the ``hedged`` trace tag.  Requires a cluster booted with
    ``PILOSA_HEDGE_AFTER`` (see SCENARIOS)."""
    h = ChaosHarness(cluster, seed, index="chaos_hedge")
    h.setup()
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(10)
    h.check_oracle()
    # guarantee a remote leg AND a remote hedge target: pick an entry
    # node holding none of some shard — with replicas=2 its two owners
    # are both other nodes (the dropped-response trace scenario's
    # discovery)
    entry = shard = None
    for i in range(h.n):
        held = h.client(i)._json(
            "GET", f"/internal/shards?index={h.index}")["shards"]
        missing = [s for s in range(3) if s not in held]
        if missing:
            entry, shard = i, missing[0]
            break
    if entry is None:
        raise h._fail("every node holds every shard; no remote leg")
    h.set_fault(entry, "dist.fanout", "delay", nth=1,
                match={"index": h.index}, args={"seconds": 1.5})
    t0 = time.monotonic()
    try:
        resp = h.client(entry)._do(
            "POST",
            f"/index/{h.index}/query?profile=true&shards={shard}",
            f"Count(Row({h.field}=0))".encode())
    finally:
        h.clear_faults()
    elapsed = time.monotonic() - t0
    count = resp["results"][0]
    acked = {c for c in h.acked.get(0, ()) if c // SHARD_WIDTH == shard}
    att = {c for c in h.attempted.get(0, ())
           if c // SHARD_WIDTH == shard}
    if not len(acked) <= count <= len(att):
        raise h._fail(f"hedged count {count} outside oracle "
                      f"[{len(acked)}, {len(att)}]")
    if elapsed >= 1.2:
        raise h._fail(f"hedge did not bound the straggler: the query "
                      f"took {elapsed:.2f}s against a 1.5s delay")

    def walk(span):
        yield span
        for child in span.get("children", []):
            yield from walk(child)

    spans = [s for root in resp["profile"] for s in walk(root)]
    if not any(s.get("tags", {}).get("hedged") for s in spans):
        raise h._fail("winning subtree lost its hedged trace tag")
    if h.counter_total(entry, "read_hedged_total") < 1:
        raise h._fail("read_hedged_total never incremented")
    h.check_oracle()
    return h


def scenario_breaker_lifecycle(cluster, seed: int) -> ChaosHarness:
    """Breaker lifecycle pinned end-to-end: an asymmetric partition
    (entry cannot reach the victim; the victim's inbound heartbeats
    keep it 'alive') accumulates transport failures until the breaker
    OPENS — reads stay exact throughout via failover, then stop
    detouring (routing skips the open peer: the failover counter goes
    quiet).  Healing the partition lets the heartbeat probe walk
    open → half_open → closed, visible in breaker_transitions_total."""
    h = ChaosHarness(cluster, seed, index="chaos_breaker")
    h.setup()
    h.random_writes(20)
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = next(i for i in range(h.n) if i != victim)
    victim_id = h.node_id(victim)
    h.set_fault(entry, "client.send", "partition",
                match={"peer": victim_id})
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        h.check_oracle(via=entry)  # must never fail while opening
        if h.breaker_state(entry, victim_id) == "open":
            break
    else:
        raise h._fail("breaker never opened under the partition")
    # open: routing skips the peer — no more failover churn
    base = h.counter_total(entry, "read_failover_total")
    for _ in range(5):
        h.check_oracle(via=entry)
    if h.breaker_state(entry, victim_id) in ("open", "half_open") \
            and h.counter_total(entry, "read_failover_total") != base:
        raise h._fail("open breaker still paid per-query failovers")
    h.clear_faults()
    # heal: the heartbeat probe closes it
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if h.breaker_state(entry, victim_id) == "closed":
            break
        time.sleep(0.2)
    else:
        raise h._fail("breaker never closed after the partition healed")
    text = h.client(entry).metrics_text()
    for leg in ('to="open"', 'to="half_open"', 'to="closed"'):
        if ("breaker_transitions_total{" not in text
                or leg not in text):
            raise h._fail(f"breaker transition {leg} not exported")
    h.check_oracle()
    return h


def scenario_clear_during_kill_handoff(cluster, seed: int) -> ChaosHarness:
    """kill -9 one of replicas=2 MID-SERVE with durable hinted handoff
    ON (the default): Set, Clear and ClearRow ALL keep serving — zero
    refusals from the kill through breaker-open — with the dead
    owner's copies durably hinted on the entry node.  After a restart
    the heartbeat-triggered drain replays the hint log in order; every
    node then answers oracle-exact, and a forced anti-entropy round on
    every node resurrects nothing (AAE deferred union-merge while the
    hints were pending — the ordering rule)."""
    h = ChaosHarness(cluster, seed, index="chaos_handoff")
    h.setup()
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(24)
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = next(i for i in range(h.n) if i != victim)
    victim_id = h.node_id(victim)
    cluster.nodes[victim].kill9()
    # serve writes THROUGH the corpse: every op class must keep acking
    # (pre-breaker legs to the dead node fail mid-apply and hand off;
    # post-open the split hints up front) — zero refusals allowed
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        row = h.rng.randrange(h.N_ROWS)
        if not h.write(row, h.rng.randrange(h.MAX_COL), via=entry):
            raise h._fail("Set refused with a replica dead")
        if not h.clear(row, h.rng.randrange(h.MAX_COL), via=entry):
            raise h._fail("Clear refused with a replica dead")
        if h.breaker_state(entry, victim_id) == "open":
            break
    else:
        raise h._fail("breaker never opened for the dead peer")
    if not h.clear_row(2, via=entry):
        raise h._fail("ClearRow refused with a replica dead")
    # post-open writes keep serving too (handoff up front now)
    if not h.write(2, 5, via=entry) or not h.clear(2, 5, via=entry):
        raise h._fail("write refused after breaker opened")
    # the missed copies are durably queued and visible on writeHealth
    wh = h.client(entry).write_health()
    if not wh.get("hintBacklogOps"):
        raise h._fail(f"no hint backlog after serving through a dead "
                      f"replica: {wh}")
    if victim_id not in {p["id"] for p in wh.get("peers", [])}:
        raise h._fail(f"dead peer missing from writeHealth: {wh}")
    for i in (coord, entry):
        h.check_oracle(via=i)  # live nodes exact while hints pend
    # restart: rejoin triggers the drain; the log must empty and every
    # node (the rejoined one included) answer oracle-exact
    node = cluster.nodes[victim]
    node.stop()  # reap the corpse + release handles
    node.start()
    node.await_up()
    cluster.await_membership(3, timeout=120)
    h.await_hints_drained(entry)
    h.await_oracle()
    if h.counter_total(entry, "hint_replay_total") < 1:
        raise h._fail("hint_replay_total never incremented")
    # the sharpest invariant: force AAE everywhere AFTER the drain —
    # union-merge must not resurrect a single cleared bit
    for i in range(h.n):
        h.client(i)._json("POST", "/internal/aae/run", {})
    h.check_oracle()
    return h


def scenario_coordinator_crash_hint_log(cluster, seed: int) -> ChaosHarness:
    """kill -9 the WRITE COORDINATOR mid-hint-append (replicas=2, one
    peer already dead and hinted): the ``hints.append`` torn-write
    failpoint persists only a prefix of the record before the crash.
    Recovery must yield a replayable-or-cleanly-truncated log — the
    acked clears (the clean prefix) replay to the rejoined peer and
    stay absent everywhere, while the torn op NEVER applies: its
    un-acked Clear's bit remains present on every node (hint-before-
    apply ordering means nothing mutated before the tear)."""
    h = ChaosHarness(cluster, seed, index="chaos_hintcrash")
    h.setup()
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(16)
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = next(i for i in range(h.n) if i != victim)
    # shards the victim replicates: a strict Clear there must hint.
    # torn_col (set in setup, still acked) is the victim of the torn
    # append — the cleared loop below stays off offset 1 so it can
    # never be legitimately cleared first.
    held = sorted(h.client(victim)._json(
        "GET", f"/internal/shards?index={h.index}")["shards"])
    if not held:
        raise h._fail("victim holds no shard — scenario invalid")
    torn_col = held[0] * SHARD_WIDTH + 1
    cluster.nodes[victim].kill9()
    # acked clears while the peer is dead: these hints form the clean
    # prefix that must survive the coordinator crash and replay
    cleared_cols = []
    deadline = time.monotonic() + 30
    while len(cleared_cols) < 4 and time.monotonic() < deadline:
        s = h.rng.choice(held)
        col = s * SHARD_WIDTH + h.rng.randrange(2, 1000)
        if h.write(0, col, via=entry) and h.clear(0, col, via=entry):
            cleared_cols.append(col)
    if len(cleared_cols) < 4:
        raise h._fail("could not ack clears through the dead replica")
    wh = h.client(entry).write_health()
    if not wh.get("hintBacklogOps"):
        raise h._fail("no hints pending before the coordinator crash")
    # tear the NEXT hint append mid-record, then kill -9 the
    # coordinator (the tear IS the crash; the kill makes it real
    # before anything else can append behind the torn tail)
    h.set_fault(entry, "hints.append", "torn_write", nth=1,
                args={"offset": h.rng.randrange(1, 20)})
    try:
        h.client(entry).query(h.index, f"Clear({torn_col}, {h.field}=0)")
    except (ClientError, OSError):
        pass  # the op must FAIL: its hint never became durable
    else:
        raise h._fail("Clear acked despite a torn hint append")
    cluster.nodes[entry].kill9()
    # restart the coordinator FIRST (it recovers the hint log and
    # advertises the backlog on its heartbeats — AAE gating resumes
    # before the stale peer can sync), then the hinted peer
    for i in (entry, victim):
        node = cluster.nodes[i]
        node.stop()
        node.start()
        node.await_up()
    cluster.await_membership(3, timeout=120)
    h.await_hints_drained(entry)
    h.await_oracle()  # acked clears absent everywhere; torn-op bit
    #                   still present everywhere (it stayed acked)
    for i in range(h.n):
        h.client(i)._json("POST", "/internal/aae/run", {})
    h.check_oracle()
    return h


def scenario_bulk_import_kill_handoff(cluster, seed: int) -> ChaosHarness:
    """kill -9 one of replicas=2 MID-BULK-IMPORT (ingest): import
    batches keep acking straight through the corpse — the dead owner's
    shard batches are durably hinted as ``kind: "import"`` records
    (visible as ``bulkOps`` on writeHealth) — and a CLEARING import
    (the strict class) serves through too.  After restart the
    heartbeat drain replays the import hints in order; every node then
    answers oracle-exact, forced AAE resurrects nothing that a
    clearing import removed, and a re-delivered replay batch is a
    NO-OP (op-id dedup covers bulk ops: the double-POST pin)."""
    h = ChaosHarness(cluster, seed, index="chaos_bulk")
    h.setup()
    # seed three shards via ONE bulk batch
    seed_pairs = [(r, s * SHARD_WIDTH + h.rng.randrange(1, 1000))
                  for s in range(3) for r in range(h.N_ROWS)]
    if not h.bulk_import(seed_pairs):
        raise h._fail("seed bulk import did not ack")
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = next(i for i in range(h.n) if i != victim)
    victim_id = h.node_id(victim)
    cluster.nodes[victim].kill9()
    # bulk-import THROUGH the corpse: every batch must keep acking
    # (pre-breaker legs fail mid-apply and hand off; post-open the
    # split hints up front) — zero refusals allowed
    acked_pairs: list = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        batch = [(h.rng.randrange(h.N_ROWS),
                  h.rng.randrange(h.MAX_COL)) for _ in range(8)]
        if not h.bulk_import(batch, via=entry):
            raise h._fail("bulk import refused with a replica dead")
        acked_pairs.extend(batch)
        if h.breaker_state(entry, victim_id) == "open":
            break
    else:
        raise h._fail("breaker never opened for the dead peer")
    # a CLEARING import (strict class — a replica that missed it would
    # resurrect via AAE) must ALSO serve through, hinted
    if not h.bulk_import(acked_pairs[:4], via=entry, clear=True):
        raise h._fail("clearing import refused with a replica dead")
    # the missed batches are durably queued and counted as BULK ops
    wh = h.client(entry).write_health()
    if not wh.get("hintBulkOps"):
        raise h._fail(f"no bulk ops in the hint backlog: {wh}")
    for i in (coord, entry):
        h.check_oracle(via=i)  # live nodes exact while hints pend
    # op-id dedup pin: the SAME replay batch delivered twice applies
    # once — the second POST dedups every op
    held = h.client(entry)._json(
        "GET", f"/internal/shards?index={h.index}")["shards"]
    dedup_col = int(sorted(held)[0]) * SHARD_WIDTH + 1001
    ops = [{"id": "bulkdedup-" + format(seed, "x"), "index": h.index,
            "op": "Import", "field": h.field, "shards": [int(sorted(held)[0])],
            "kind": "import",
            "import": {"mode": "bits", "rows": [0], "cols": [dedup_col],
                       "clear": False}}]
    h.attempted.setdefault(0, set()).add(dedup_col)
    r1 = h.client(entry)._json("POST", "/internal/hints/replay",
                               {"ops": ops})
    r2 = h.client(entry)._json("POST", "/internal/hints/replay",
                               {"ops": ops})
    if r1.get("applied") != 1 or r2.get("deduped") != 1 \
            or r2.get("applied"):
        raise h._fail(f"bulk op-id dedup broken: first={r1} second={r2}")
    # restart: rejoin triggers the drain; every node answers
    # oracle-exact and forced AAE resurrects nothing cleared
    node = cluster.nodes[victim]
    node.stop()
    node.start()
    node.await_up()
    cluster.await_membership(3, timeout=120)
    h.await_hints_drained(entry)
    h.await_oracle()
    for i in range(h.n):
        h.client(i)._json("POST", "/internal/aae/run", {})
    h.check_oracle()
    return h


def scenario_corrupt_fragment_scrub_repair(cluster,
                                           seed: int) -> ChaosHarness:
    """Byte-flip a fragment snapshot on disk (replicas=2): the
    background scrubber must DETECT the corruption (frame CRC),
    QUARANTINE the fragment — reads of the affected shard keep
    answering oracle-exact throughout, zero failures, because the
    victim's own routing skips the quarantined fragment and a peer's
    fan-out leg gets a 503 that rides the replica-failover path —
    then AUTO-REPAIR it from the healthy replica (full position pull,
    wholesale rebuild, fresh framed snapshot, re-verify), after which
    a forced anti-entropy round on every node finds ZERO divergence
    (resurrects nothing).  Requires a cluster booted with a sub-second
    scrub interval and periodic AAE off (see SCENARIOS) — pre-
    detection, an AAE round could diff the corrupt copy outward; the
    scrub interval is exactly the knob that bounds that window."""
    h = ChaosHarness(cluster, seed, index="chaos_scrub")
    h.setup()
    for s in range(3):
        if not h.write(0, s * SHARD_WIDTH + 1):
            raise h._fail("setup write did not ack")
    h.random_writes(24)
    h.check_oracle()
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    # force snapshots to disk on the victim (the tar-backup endpoint
    # compacts every dirty fragment), then flip one byte of shard 0's
    # snapshot blob IN PLACE (r+b: truncating would SIGBUS the mmap)
    h.client(victim)._do("GET", "/internal/backup")
    frag_path = os.path.join(cluster.nodes[victim].data_dir,
                              h.index, h.field, "views", "standard",
                              "fragments", "0")
    with open(frag_path, "rb") as f:
        head = f.read(4)
    if head != b"PSF1":
        raise h._fail(f"snapshot at {frag_path} is not framed: {head!r}")
    size = os.path.getsize(frag_path)
    with open(frag_path, "r+b") as f:
        f.seek(size - 2)
        byte = f.read(1)
        f.seek(size - 2)
        f.write(bytes([byte[0] ^ 0x55]))
    # the scrubber (sub-second interval) must detect the flip.  The
    # repair hook runs in the SAME pass, so the quarantine window can
    # be too short to observe on /status — the detection counter is
    # the reliable witness
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if h.counter_total(victim,
                           "storage_corruption_detected_total") >= 1:
            break
        time.sleep(0.1)
    else:
        raise h._fail("scrubber never detected the flipped byte")
    # from detection on: EVERY read on EVERY node answers oracle-exact
    # — zero failures — while repair converges in the background
    # (quarantined legs 503 and ride the replica-failover path)
    repaired = False
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        for i in range(h.n):
            try:
                h.check_oracle(via=i)
            except InvariantViolation:
                raise
            except (ClientError, OSError) as e:
                raise h._fail(f"read failed during quarantine: {e!r}")
        sh = h.client(victim)._json(
            "GET", "/status").get("storageHealth", {})
        if not sh.get("quarantined") \
                and h.counter_total(victim, "storage_repair_total") >= 1:
            repaired = True
            break
    if not repaired:
        raise h._fail("quarantined fragment was never repaired")
    if h.counter_total(victim, "storage_corruption_detected_total") < 1:
        raise h._fail("storage_corruption_detected_total never counted")
    if h.counter_total(victim, "storage_repair_total") < 1:
        raise h._fail("storage_repair_total never counted")
    last = h.client(victim)._json(
        "GET", "/status")["storageHealth"].get("lastRepair")
    if not last:
        raise h._fail("storageHealth.lastRepair missing after repair")
    # the repaired bytes must re-verify as a healthy framed snapshot
    with open(frag_path, "rb") as f:
        if f.read(4) != b"PSF1":
            raise h._fail("repair did not rewrite a framed snapshot")
    # forced AAE everywhere: ZERO divergence (the repair pulled the
    # replica's full set — union-merge must find nothing to move)
    for i in range(h.n):
        got = h.client(i)._json("POST", "/internal/aae/run", {})
        if got.get("repaired"):
            raise h._fail(
                f"forced AAE on node {i} repaired "
                f"{got['repaired']} blocks after replica repair "
                "(divergence survived)")
    h.check_oracle()
    h.await_replica_convergence(expected_holders=2)
    return h


def scenario_disk_full_during_ingest(cluster, seed: int) -> ChaosHarness:
    """ENOSPC mid-bulk-import (replicas=2): the victim's first
    failing op-log append flips it READ-ONLY — bulk-import batches via
    the healthy entry node keep ACKING (the victim's 507 legs are
    classified hint-worthy and durably hinted),
    direct writes at the victim refuse with the structured 507
    ``writeUnavailable{reason: "disk_full"}`` (never a crash, never a
    torn ack), reads keep answering on BOTH nodes — then 'freeing
    space' (clearing the fault) lets the probe restore HEALTHY, the
    heartbeat drain replays the hinted batches in order, and every
    node ends bit-exact (forced AAE resurrects nothing).  Requires a
    sub-second disk probe (see SCENARIOS)."""
    h = ChaosHarness(cluster, seed, index="chaos_enospc")
    h.setup()
    seed_pairs = [(r, s * SHARD_WIDTH + h.rng.randrange(1, 1000))
                  for s in range(3) for r in range(h.N_ROWS)]
    if not h.bulk_import(seed_pairs):
        raise h._fail("seed bulk import did not ack")
    h.check_oracle()
    # the mid-outage oracle: bits acked BEFORE the disk fills must
    # stay readable on every node throughout (the read-only replica
    # is merely STALE for the writes hinted PAST it — the standard
    # replica-consistency caveat — so the full oracle only applies
    # again after the drain)
    pre_acked = {r: set(c) for r, c in h.acked.items()}
    coord = h.coordinator_index()
    victim = next(i for i in range(h.n) if i != coord)
    entry = coord
    # ENOSPC on every durable write under the victim's data dir —
    # op-logs, snapshots AND the governor's probe file, so the node
    # stays read-only until the 'disk' recovers (fault cleared)
    h.set_fault(victim, "sys.write", "error",
                args={"errno": "ENOSPC"},
                match={"path": cluster.nodes[victim].data_dir})
    # bulk-import THROUGH the full disk: every batch must keep acking
    # (the victim's legs refuse 507 and hand off as hints)
    flipped = False
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        batch = [(h.rng.randrange(h.N_ROWS),
                  h.rng.randrange(h.MAX_COL)) for _ in range(8)]
        if not h.bulk_import(batch, via=entry):
            raise h._fail("bulk import refused while one replica's "
                          "disk is full")
        st = h.client(victim)._json(
            "GET", "/status").get("storageHealth", {})
        if st.get("state") == "read_only":
            flipped = True
            break
    if not flipped:
        raise h._fail("victim never flipped read-only under ENOSPC")
    # structured refusal at the read-only node: a direct strict write
    # must answer 507 with the writeUnavailable{disk_full} body (raw
    # request — the client helper strips the structured fields)
    import http.client as _httpc
    import json as _json
    # at-least-once honest: the healthy replica's leg may apply before
    # the read-only node's local leg refuses — an attempted, un-acked
    # write (exactly the torn-ack class the oracle absorbs)
    h.attempted.setdefault(0, set()).add(1)
    h.cleared.setdefault(0, set()).discard(1)
    conn = _httpc.HTTPConnection("127.0.0.1",
                                 cluster.nodes[victim].port, timeout=15)
    try:
        body = f"Set(1, {h.field}=0)".encode()
        conn.request("POST", f"/index/{h.index}/query", body,
                     headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        payload = _json.loads(resp.read().decode())
    finally:
        conn.close()
    if resp.status != 507:
        raise h._fail(f"read-only write answered {resp.status}, want "
                      f"the structured 507: {payload}")
    wu = payload.get("writeUnavailable") or {}
    if wu.get("reason") != "disk_full":
        raise h._fail(f"507 body lacks writeUnavailable.disk_full: "
                      f"{payload}")
    if not resp.getheader("Retry-After"):
        raise h._fail("507 refusal carries no Retry-After header")
    # the hinted backlog for the victim is durably queued on the entry
    wh = h.client(entry).write_health()
    if not wh.get("hintBacklogOps"):
        raise h._fail(f"no hints queued for the disk-full replica: {wh}")
    # reads: full availability on BOTH nodes — every query answers,
    # pre-outage acked bits all present, nothing phantom, Count
    # consistent (writes hinted DURING the outage may lag on legs the
    # stale replica serves; the full oracle re-applies after drain)
    for i in range(h.n):
        for row in range(h.N_ROWS):
            try:
                res = h.client(i).query(
                    h.index,
                    f"Row({h.field}={row})"
                    f"Count(Row({h.field}={row}))")
            except (ClientError, OSError) as e:
                raise h._fail(
                    f"read failed on node {i} during disk-full: {e!r}")
            got = set(res[0]["columns"])
            if not pre_acked.get(row, set()) <= got:
                raise h._fail(
                    f"node {i} row {row}: pre-outage acked bits lost "
                    f"during disk-full degradation")
            if not got <= h.attempted.get(row, set()):
                raise h._fail(f"node {i} row {row}: phantom bits "
                              "during disk-full degradation")
            if res[1] != len(got):
                raise h._fail(f"node {i} row {row}: Count/Row mismatch "
                              "during disk-full degradation")
    if h.counter_total(victim, "fault_triggered_total") < 1:
        raise h._fail("the ENOSPC fault never actually fired")
    # 'free space': clear the fault — the probe restores HEALTHY
    h.clear_faults()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        st = h.client(victim)._json(
            "GET", "/status").get("storageHealth", {})
        if st.get("state") == "healthy":
            break
        time.sleep(0.2)
    else:
        raise h._fail("victim never recovered after space freed")
    # the drain replays the hinted batches; every node ends bit-exact
    h.await_hints_drained(entry)
    h.await_oracle()
    if h.counter_total(entry, "hint_replay_total") < 1:
        raise h._fail("hint_replay_total never incremented")
    for i in range(h.n):
        h.client(i)._json("POST", "/internal/aae/run", {})
    h.check_oracle()
    return h


def scenario_hung_dispatch_serving(cluster, seed: int) -> ChaosHarness:
    """A device dispatch HANGS mid-serve: the ``exec.dispatch_hang``
    failpoint stalls one plane's whole-plane row-count dispatch (the
    kind a multi-Count request over index A rides) while concurrent
    single-Count traffic against index B keeps flowing.  Invariants:

    - every B query from before the hang to after recovery answers
      oracle-exact — ZERO failures (availability 1.0 for unaffected
      work: the watchdog bounds the stall per group/window, so B's
      items are never wedged behind A's sick dispatch);
    - the wedged A caller receives a STRUCTURED error naming the
      stalled stage (504 timeout with ``stage`` or 500
      ``pipelineStall``) within its deadline + one watchdog period +
      grace — never a hung connection;
    - the watchdog trip degrades the governor and, after the fault
      clears, probing returns it to HEALTHY (visible on /status
      deviceHealth);
    - no leaked pipeline threads after recovery: exactly one collector
      and at most one readback worker remain once the zombie unwedges
      (the post-scenario thread census, via /debug/threads).

    Requires a cluster booted with a sub-second watchdog + probe and
    the solo fast lane off (see SCENARIOS extra_env) — the hang must
    land in the windowed dispatch the watchdog governs.

    The port differs from the reference here (``ROADMAP.md``, "Pinned":
    a quarantined window's lifetime): launched work cannot be cancelled,
    so the quarantined window keeps its operands until its CUDA event
    completes (``CountBatcher._limbo``), and the census counts the port's
    threads (``pilosa-torch-batcher``, ``pilosa-torch-readback``,
    ``pilosa-torch-watchdog``).  The invariants are the reference's."""
    h = ChaosHarness(cluster, seed, index="chaos_hang_a")
    c = h.client(0)
    index_b = "chaos_hang_b"
    h.setup()
    c.create_index(index_b)
    c.create_field(index_b, h.field)
    # deterministic oracles: all writes happen BEFORE the fault
    want_a = {}
    for row in range(3):
        cols = {h.rng.randrange(h.MAX_COL) for _ in range(6)}
        for col in cols:
            c.query(h.index, f"Set({col}, {h.field}={row})")
        want_a[row] = len(cols)
    want_b = {}
    for row in range(3):
        cols = {h.rng.randrange(h.MAX_COL) for _ in range(5)}
        for col in cols:
            c.query(index_b, f"Set({col}, {h.field}={row})")
        want_b[row] = len(cols)
    # warm both planes: the multi-Count A request must ride the
    # resident whole-plane rowcounts path before the hang is armed.
    # Retried: the scenario boots with a 0.4s watchdog, and a first
    # plane build or kernel load outliving it just gets a quarantine
    # 500 — a retry finds the plane resident.
    pql_a = "".join(f"Count(Row({h.field}={r}))" for r in range(3))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            if c.query(h.index, pql_a) == [want_a[r] for r in range(3)]:
                break
        except (ClientError, OSError):
            pass
        time.sleep(0.2)
    else:
        raise h._fail("index A plane never warmed")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            if all(c.query(index_b, f"Count(Row({h.field}={row}))")
                   == [want_b[row]] for row in range(3)):
                break
        except (ClientError, OSError):
            pass
        time.sleep(0.2)
    else:
        raise h._fail("index B never warmed oracle-exact")
    # if a warm-up compile tripped the 0.4s watchdog, let the governor
    # probe back before the measured episode starts (queries must keep
    # flowing — probes ride collection windows)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            c.query(index_b, f"Count(Row({h.field}=0))")
            if c._json("GET", "/status")["deviceHealth"]["state"] \
                    == "healthy":
                break
        except (ClientError, OSError):
            pass
        time.sleep(0.1)
    else:
        raise h._fail("governor not healthy before the hang")

    # unaffected traffic: hammer B single-Counts THROUGH the stall
    import threading
    b_errors: list = []
    b_served = [0]
    stop_at = [time.monotonic() + 12.0]

    def b_reader(i: int) -> None:
        bc = cluster.client(0)
        row = i % 3
        while time.monotonic() < stop_at[0]:
            try:
                got = bc.query(index_b,
                               f"Count(Row({h.field}={row}))")
            except (ClientError, OSError) as e:
                b_errors.append(f"B query failed: {e!r}")
                return
            if got != [want_b[row]]:
                b_errors.append(f"B answer diverged: {got} != "
                                f"[{want_b[row]}]")
                return
            b_served[0] += 1
    readers = [threading.Thread(target=b_reader, args=(i,))
               for i in range(4)]
    for t in readers:
        t.start()
    time.sleep(0.5)  # readers established through the healthy path
    # the hang: one plane's (index A's) rowcounts dispatch stalls for
    # 2s — well past the 0.4s watchdog — exactly once
    h.set_fault(0, "exec.dispatch_hang", "delay", times=1,
                match={"kind": "rowcounts"}, args={"seconds": 2.0})
    t0 = time.monotonic()
    try:
        c._do("POST", f"/index/{h.index}/query?timeout=1.0",
              pql_a.encode())
    except ClientError as e:
        elapsed = time.monotonic() - t0
        if e.status not in (500, 504):
            raise h._fail(
                f"wedged caller got status {e.status}, not a "
                f"structured 500/504: {e}")
        msg = str(e)
        if "dispatch" not in msg and "pipeline" not in msg \
                and "stage" not in msg:
            raise h._fail(f"error does not name the stalled stage: "
                          f"{msg!r}")
        # deadline (1.0) + one watchdog period (0.4) + grace
        if elapsed > 1.0 + 0.4 + 1.0:
            raise h._fail(f"wedged caller held {elapsed:.2f}s — past "
                          f"deadline + watchdog + grace")
    else:
        raise h._fail("query through a hung dispatch succeeded "
                      "inside its 1s deadline against a 2s stall")
    finally:
        h.clear_faults()
    # the governor tripped (watchdog) and must probe back to healthy
    deadline = time.monotonic() + 20
    saw_degraded = False
    while time.monotonic() < deadline:
        dh = c._json("GET", "/status").get("deviceHealth", {})
        if dh.get("state") in ("degraded", "probing"):
            saw_degraded = True
        if saw_degraded and dh.get("state") == "healthy":
            break
        time.sleep(0.1)
    else:
        raise h._fail(
            f"governor never walked degraded→healthy after the hang "
            f"(last state {dh.get('state')!r}, saw_degraded="
            f"{saw_degraded})")
    if h.counter_total(0, "pipeline_watchdog_trips_total") < 1:
        raise h._fail("pipeline_watchdog_trips_total never incremented")
    if h.counter_total(0, "pipeline_quarantined_windows_total") < 1:
        raise h._fail("no window was ever quarantined")
    # flight recorder: the trip auto-dumped an artifact, the
    # live ring resolves via /debug/flight, and the quarantine event
    # names the stalled stage
    flight = c._json("GET", "/debug/flight")
    quar = [e for e in flight.get("events", ())
            if e.get("kind") == "quarantine"]
    if not quar:
        raise h._fail("no quarantine event in /debug/flight after "
                      "the watchdog trip")
    if not any(e.get("detail") in ("dispatch", "readback")
               for e in quar):
        raise h._fail(f"quarantine flight event does not name a "
                      f"pipeline stage: {quar[:3]}")
    dumps = flight.get("dumps", ())
    if not dumps:
        raise h._fail("watchdog trip produced no flight-dump artifact")
    if not os.path.exists(dumps[-1]):
        raise h._fail(f"flight dump path does not resolve on disk: "
                      f"{dumps[-1]}")
    # recovered: A serves exact again (fresh collector, healthy state)
    if c.query(h.index, pql_a) != [want_a[r] for r in range(3)]:
        raise h._fail("index A diverged after recovery")
    stop_at[0] = 0.0
    for t in readers:
        t.join(timeout=30)
    if b_errors:
        raise h._fail(f"unaffected traffic failed through the stall: "
                      f"{b_errors[:3]}")
    if b_served[0] < 8:
        raise h._fail(f"B readers served only {b_served[0]} queries — "
                      f"not meaningful coverage of the stall window")
    # thread census: after the 2s delay resolves, the superseded
    # zombie collector exits — exactly one live collector, at most
    # one readback worker, at most one watchdog remain
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        dump = h.client(0)._do("GET", "/debug/threads").decode()
        census = {
            name: dump.count(f"Thread {name} (")
            for name in ("pilosa-torch-batcher",
                         "pilosa-torch-readback",
                         "pilosa-torch-watchdog")}
        if (census["pilosa-torch-batcher"] == 1
                and census["pilosa-torch-readback"] <= 1
                and census["pilosa-torch-watchdog"] <= 1):
            break
        time.sleep(0.3)
    else:
        raise h._fail(f"pipeline threads leaked after recovery: "
                      f"{census}")
    return h


def scenario_flaky_device_governor(cluster, seed: int,
                                   times: int = 4) -> ChaosHarness:
    """A FLAKY-then-healthy device: ``exec.dispatch_error`` fails
    ``times`` consecutive dispatches until the governor's breaker
    degrades serving; once the fault schedule is spent, a probe window
    flips it back to healthy.  Invariants: the governor walks
    healthy→degraded→(probing)→healthy on /status,
    ``fault_triggered_total`` reaches 3, ``device_health_state`` is
    exported on /metrics, and every answer is exact.

    The port differs from the reference here (``ROADMAP.md``, "Pinned":
    no fallback behind a failing launch): the reference serves a faulted
    window item by item, the port raises to its callers.  So at most
    ``times`` requests may answer the 500 that names the injected fault;
    every other answer must be exact.  Requires a cluster booted with a
    sub-second probe interval and the solo fast lane off (see SCENARIOS
    extra_env)."""
    h = ChaosHarness(cluster, seed, index="chaos_flaky")
    c = h.client(0)
    h.setup()
    for row in range(3):
        for _ in range(5):
            if not h.write(row, h.rng.randrange(h.MAX_COL)):
                raise h._fail("setup write did not ack")
    want = {row: len(h.acked.get(row, ())) for row in range(3)}
    for row in range(3):  # warm the fused path
        if c.query(h.index, f"Count(Row({h.field}={row}))") \
                != [want[row]]:
            raise h._fail("warmup count diverged")
    if c._json("GET", "/status")["deviceHealth"]["state"] != "healthy":
        raise h._fail("governor not healthy before the fault")
    # enough consecutive faults to cross the breaker threshold (3),
    # plus one to fail the first probe — then the device 'heals'
    h.set_fault(0, "exec.dispatch_error", "error", times=times)
    saw = {"degraded": False, "healthy_again": False}
    refused = 0
    deadline = time.monotonic() + 30
    i = 0
    try:
        while time.monotonic() < deadline:
            row = i % 3
            i += 1
            try:
                got = c.query(h.index, f"Count(Row({h.field}={row}))")
            except ClientError as e:
                # a faulted window raises to its callers: a 500 that
                # names the injected fault, at most once per fault
                refused += 1
                if e.status != 500 or "injected fault" not in str(e):
                    raise h._fail(f"a faulted window answered {e.status}"
                                  f" without naming the fault: {e}")
                if refused > times:
                    raise h._fail(f"{refused} requests refused for "
                                  f"{times} injected faults")
                got = None
            if got is not None and got != [want[row]]:
                raise h._fail(
                    f"answer diverged under dispatch faults: {got} != "
                    f"[{want[row]}] (degraded serving must stay exact)")
            state = c._json("GET", "/status")["deviceHealth"]["state"]
            if state in ("degraded", "probing"):
                saw["degraded"] = True
            elif state == "healthy" and saw["degraded"]:
                saw["healthy_again"] = True
                break
            time.sleep(0.05)
    finally:
        h.clear_faults()
    if not saw["degraded"]:
        raise h._fail("governor never degraded under consecutive "
                      "dispatch faults")
    if not saw["healthy_again"]:
        raise h._fail("governor never probed back to healthy after "
                      "the fault schedule exhausted")
    if h.counter_total(0, "fault_triggered_total") < 3:
        raise h._fail("dispatch faults never actually fired")
    if "device_health_state" not in c.metrics_text():
        raise h._fail("device_health_state missing from /metrics")
    h.check_oracle()
    return h


SCENARIOS = {
    "partition_during_resize": (scenario_partition_during_resize, 3),
    "crash_mid_oplog_append": (scenario_crash_mid_oplog_append, 1),
    "duplicate_delivery": (scenario_duplicate_delivery, 2),
    "dropped_placement_broadcast": (scenario_dropped_placement_broadcast,
                                    2),
    "dropped_internal_response_trace":
        (scenario_dropped_internal_response_trace, 3),
    # serving through failure (the third element, when present, is
    # extra env the scenario's cluster must boot with)
    "node_kill_failover": (scenario_node_kill_failover, 3,
                           {"PILOSA_HINT_MAX_AGE": "0"}),
    # hedging is a boot-time knob (off by default); the periodic sweep
    # stays off, as in the reference's test of this scenario
    "straggler_hedged_read": (scenario_straggler_hedged_read, 3,
                              {"PILOSA_HEDGE_AFTER": "0.15",
                               "PILOSA_ANTI_ENTROPY_INTERVAL": "0"}),
    "breaker_lifecycle": (scenario_breaker_lifecycle, 3),
    # writes through failure (durable hinted handoff)
    "clear_during_kill_handoff": (scenario_clear_during_kill_handoff, 3),
    "coordinator_crash_hint_log": (scenario_coordinator_crash_hint_log,
                                   3),
    # ingest (bulk imports through failure, op-id dedup)
    "bulk_import_kill_handoff": (scenario_bulk_import_kill_handoff, 3),
    # storage integrity (scrub + quarantine + replica repair,
    # disk-full governor): sub-second scrub/probe so the drills finish
    # under tier-1; periodic AAE off for the corruption drill (pre-
    # detection, an AAE round could diff the corrupt copy outward —
    # the scrub interval is the knob bounding that window)
    "corrupt_fragment_scrub_repair":
        (scenario_corrupt_fragment_scrub_repair, 2,
         {"PILOSA_SCRUB_INTERVAL_SECONDS": "0.4",
          "PILOSA_ANTI_ENTROPY_INTERVAL": "0"}),
    "disk_full_during_ingest":
        (scenario_disk_full_during_ingest, 2,
         {"PILOSA_DISK_PROBE_SECONDS": "0.3"}),
    # the self-healing dispatch pipeline (watchdog, quarantine,
    # device health governor): sub-second watchdog/probe so the
    # scenarios finish under tier-1, fast lane off so the injected
    # hang lands in the windowed dispatch the watchdog governs
    "hung_dispatch_serving": (scenario_hung_dispatch_serving, 1,
                              {"PILOSA_DISPATCH_WATCHDOG_SECONDS": "0.4",
                               "PILOSA_DEVICE_HEALTH_PROBE_SECONDS":
                                   "0.4",
                               "PILOSA_SOLO_FASTLANE": "0",
                               "PILOSA_COUNT_BATCH_WINDOW": "0.002"}),
    "flaky_device_governor": (scenario_flaky_device_governor, 1,
                              {"PILOSA_DEVICE_HEALTH_PROBE_SECONDS":
                                   "0.3",
                               "PILOSA_SOLO_FASTLANE": "0",
                               "PILOSA_COUNT_BATCH_WINDOW": "0.002"}),
}


def run_scenario(name: str, seed: int, base_dir: str,
                 device: str = "") -> ChaosHarness:
    """Boot ``name``'s process cluster under ``base_dir`` on ``device``
    (``""``: the CUDA device) and run the scenario in it."""
    from pilosa_tpu_torch.testing import run_process_cluster
    fn, n_nodes, *rest = SCENARIOS[name]
    extra_env = rest[0] if rest else None
    replicas = 2 if n_nodes > 1 else 1
    os.makedirs(base_dir, exist_ok=True)
    with run_process_cluster(n_nodes, base_dir, replicas=replicas,
                             anti_entropy=1.0, device=device,
                             extra_env=extra_env) as cluster:
        return fn(cluster, seed)


def main(argv: list[str] | None = None) -> int:
    """Runbook entry: boot process clusters in a temp dir and run the
    scripted scenarios.  Exit 0 = every invariant held."""
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="chaos harness")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scenario", default="all",
                    choices=["all", *SCENARIOS])
    ap.add_argument("--device", default="",
                    help="torch device of every node; default: the CUDA "
                         "device")
    args = ap.parse_args(argv)
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
            run_scenario(name, args.seed, tmp, device=args.device)
        print(f"[chaos] {name}: OK (seed={args.seed})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
