"""The port's cluster against the JAX package's, on the CPU.

One 3-node in-process cluster of each package (``replicas = 2``, the
periodic anti-entropy off) over ports that sort alike, so jump-hash
placement puts every shard on the same node position in both, and the
same seeded numpy data imported through each cluster's own routes.  The
module's tests run in order on those two clusters:

- distributed reads, asked of every port node: Count batches and trees, Row,
  TopN (filtered, tanimoto), BSI Sum/Min/Max/range, GroupBy (having,
  limit, Sum/Min/Max aggregates), Extract over Limit and ConstRow, Limit
  paging, Distinct, Percentile, Rows, keyed reads of a keyed field and a
  keyed index after translate replication, with equal JSON;
- replicated writes: a PQL ``Set`` / ``Clear`` and a 4096-pair import sent
  through the node that does not own the shard land on both owners'
  holders and on neither holder of the other node;
- hinted handoff: writes while a replica is down are hinted (hint logs
  byte-equal across packages), a refusal past ``hint_max_age`` answers the
  same 503 ``writeUnavailable`` body, the reopened node replays them (its
  ``IdWindow`` file byte-equal) and holds what its replica holds;
- anti-entropy: a triggered round repairs a replica diverged both ways
  (``blocks()`` checksums equal), the receiver's resident plane answering
  the merged bits through its journal, and ``repair_quarantined``
  rebuilds a quarantined fragment from its replica (a plane rebuild);
- resize: a fourth node's join moves shards to it, an abort answers as
  the reference's, and the node's removal moves them back;
- ``render_cluster_metrics`` text and ``/metrics/cluster``;
- at the end, every node's fragment snapshots byte-equal across packages.
"""

import json
import os
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cli.config import Config as JConfig
from pilosa_tpu.cluster import dist as jdist
from pilosa_tpu.cluster import hints as jhints
from pilosa_tpu.obs import metrics as jmetrics
from pilosa_tpu.server import PilosaTPUServer as JServer
from pilosa_tpu.testing import TestCluster as JTestCluster
from pilosa_tpu_torch.api.client import Client, ClientError
from pilosa_tpu_torch.cluster import dist as tdist
from pilosa_tpu_torch.cluster import hints as thints
from pilosa_tpu_torch.ingest import bulk as tbulk
from pilosa_tpu_torch.obs import metrics as tmetrics
from pilosa_tpu_torch.server import PilosaTPUServer as TServer
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.testing import TestCluster as TTestCluster
from pilosa_tpu_torch.testing import free_ports, node_config
from pilosa_tpu.ingest import bulk as jbulk

SW = 1 << 20
N_SHARDS = 4
HB = 0.5  # suspect after 1.5 s: a loaded worker must not falsely suspect
PKGS = ("jax", "torch")
KEYS = ["red", "green", "blue", "cyan", "gold"]


def _jconfig(i, base, seed, port):
    return JConfig(bind=f"127.0.0.1:{port}", data_dir=f"{base}/node{i}",
                   seeds=[seed] if seed else [], replicas=2,
                   cluster_enabled=True, heartbeat_interval=HB,
                   anti_entropy_interval=0.0, mesh=False)


def _tconfig(i, base, seed, port):
    return node_config(i, base, seed, port=port, replicas=2, heartbeat=HB,
                       device="cpu")


MAKE = {"jax": (JServer, _jconfig, JTestCluster),
        "torch": (TServer, _tconfig, TTestCluster)}


def _boot(pkg, base, ports):
    server_cls, make_cfg, cluster_cls = MAKE[pkg]
    servers, seed = [], None
    for i, port in enumerate(ports):
        srv = server_cls(make_cfg(i, base, seed, port)).open()
        servers.append(srv)
        seed = seed or srv.cluster.node_id
    c = cluster_cls(servers)
    c.await_membership(len(ports))
    c.await_state("NORMAL")
    return c


def _client(srv) -> Client:
    return Client("127.0.0.1", srv.http.address[1], timeout=60.0)


def _data():
    """Seeded bits of f (8 rows) and g (4 rows), values of a, keyed rows
    of s, over N_SHARDS shards; and keyed index k's pairs."""
    rng = np.random.default_rng(14)
    cols = np.concatenate([s * SW + rng.choice(4096, 120, replace=False)
                           for s in range(N_SHARDS)])
    f_rows = rng.integers(0, 8, len(cols))
    g_cols = rng.choice(cols, 300, replace=False)
    g_rows = rng.integers(0, 4, len(g_cols))
    a_cols = rng.choice(cols, 200, replace=False)
    a_vals = rng.integers(-20, 120, len(a_cols))
    s_cols = rng.choice(cols, 150, replace=False)
    s_keys = [KEYS[i] for i in rng.integers(0, len(KEYS), len(s_cols))]
    k_cols = [f"c{i}" for i in rng.integers(0, 60, 200)]
    k_rows = [f"r{i}" for i in rng.integers(0, 6, 200)]
    return dict(f=(f_rows, cols), g=(g_rows, g_cols), a=(a_cols, a_vals),
                s=(s_keys, s_cols), k=(k_rows, k_cols))


def _load(c, d):
    cl = _client(c.servers[0])
    cl.create_index("i")
    cl.create_field("i", "f")
    cl.create_field("i", "g")
    cl.create_field("i", "a", {"type": "int", "min": -20, "max": 120})
    cl.create_field("i", "s", {"keys": True})
    cl.create_index("k", {"keys": True})
    cl.create_field("k", "kf", {"keys": True})
    for name in ("w", "h", "ae"):
        cl.create_index(name)
        cl.create_field(name, "f")
    for name in ("f", "g"):
        rows, cols = d[name]
        cl.import_bits("i", name, rowIDs=[int(r) for r in rows],
                       columnIDs=[int(x) for x in cols])
    a_cols, a_vals = d["a"]
    cl.import_values("i", "a", columnIDs=[int(x) for x in a_cols],
                     values=[int(v) for v in a_vals])
    s_keys, s_cols = d["s"]
    # keyed rows through a node that is not the coordinator
    _client(c.servers[2]).import_bits(
        "i", "s", rowKeys=s_keys, columnIDs=[int(x) for x in s_cols])
    k_rows, k_cols = d["k"]
    _client(c.servers[1]).import_bits("k", "kf", rowKeys=k_rows,
                                      columnKeys=k_cols)


class _Ids:
    """Deterministic op ids for one package's write path."""

    def __init__(self):
        self.n = 0

    def urandom(self, k: int) -> bytes:
        self.n += 1
        return self.n.to_bytes(k, "big")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both packages' clusters, loaded; their ports ascend alike (the
    fourth port of each is for the resize test's joining node)."""
    ports = free_ports(8)
    # node positions sort alike in both: each package's four ports
    # ascend as strings, and every torch port sorts after every jax one
    jports, tports = ports[:4], ports[4:]
    base = tmp_path_factory.mktemp("clusters")
    out = {}
    d = _data()
    mp = pytest.MonkeyPatch()
    # op ids from a counter per package (hint logs and IdWindow files
    # then compare byte for byte)
    for dist_mod, bulk_mod in ((jdist, jbulk), (tdist, tbulk)):
        ids = _Ids()
        mp.setattr(dist_mod, "os", ids)
        mp.setattr(bulk_mod, "os", ids)
    try:
        for pkg, pp in (("jax", jports), ("torch", tports)):
            out[pkg] = _boot(pkg, str(base / pkg), pp[:3])
            out[pkg].ports = pp
            out[pkg].base = str(base / pkg)
            _load(out[pkg], d)
        yield out
    finally:
        mp.undo()
        for c in out.values():
            for s in c.servers:
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass


def _pos(c):
    """Node ids of a cluster by position."""
    return {s.cluster.node_id: i for i, s in enumerate(c.servers)}


def _norm(text: str, c) -> str:
    for nid, i in _pos(c).items():
        text = text.replace(nid, f"<node{i}>")
    return text


def _frag(srv, index, field, shard):
    idx = srv.holder.index(index)
    f = idx.field(field) if idx is not None else None
    v = f.standard_view() if f is not None else None
    return v.fragment(shard) if v is not None else None


def _positions(srv, index, field, shard) -> list[int]:
    frag = _frag(srv, index, field, shard)
    return [] if frag is None else frag.positions().tolist()


READS = [
    "Count(Row(f=1))",
    "Count(Row(f=1)) Count(Row(f=2)) Count(Row(g=0)) Count(Row(g=3))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Difference(Row(f=1), Row(g=0)))",
    "Row(f=3)",
    "Row(f=5) Count(Row(f=6))",
    "TopN(f, n=4)",
    "TopN(f, Row(g=1), n=3)",
    "TopN(f, Row(g=2), tanimoto=20)",
    "Sum(field=a)", "Min(field=a)", "Max(field=a)",
    "Sum(Row(f=1), field=a)",
    "Count(Row(a > 90))",
    "Row(a < -15)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), having=Condition(count > 8))",
    "GroupBy(Rows(g), aggregate=Sum(field=a))",
    "GroupBy(Rows(g), aggregate=Min(field=a))",
    "GroupBy(Rows(g), aggregate=Max(field=a))",
    "GroupBy(Rows(f), limit=3)",
    "Extract(Limit(Row(f=1), limit=5), Rows(f), Rows(a), Rows(s))",
    "Limit(Row(f=2), limit=7, offset=3)",
    "Distinct(field=a)",
    "Distinct(Row(f=1), field=a)",
    "Percentile(field=a, nth=50)",
    "Percentile(field=a, nth=90)",
    "Rows(f)",
    "Rows(g, limit=2)",
    'Count(Row(s="red"))',
    'Row(s="blue")',
    "TopN(s, n=3)",
    "Rows(s)",
    "GroupBy(Rows(s), Rows(g))",
    'Count(Row(s="nosuchkey"))',
]
K_READS = ['Count(Row(kf="r1"))', 'Row(kf="r2")', "TopN(kf, n=2)",
           "Rows(kf)"]


def test_distributed_reads_equal(clusters):
    d = _data()
    c0 = clusters["jax"].servers[0]
    extract = "Extract(ConstRow(columns=[%d, %d, %d]), Rows(g), Rows(f))" % (
        int(d["f"][1][0]), int(d["f"][1][200]), int(d["f"][1][400]))
    for index, reads in (("i", READS + [extract]), ("k", K_READS)):
        for pql in reads:
            # the reference asked through one node, the port through each
            answers = {("jax", 0): _client(c0).query(index, pql)}
            for n, srv in enumerate(clusters["torch"].servers):
                answers[("torch", n)] = _client(srv).query(index, pql)
            want = answers[("jax", 0)]
            assert all(a == want for a in answers.values()), (pql, answers)
    # the numpy oracle of the plainest read
    f_rows, f_cols = d["f"]
    assert _client(c0).query("i", "Count(Row(f=1))") == [
        int((f_rows == 1).sum())]


def test_primaries_served_their_shards(clusters):
    """Reads route each shard to its first live owner: every port node
    that is some shard's primary ran partials through its own executor,
    and the primaries sit at the same node positions in both packages."""
    prim = {}
    for pkg in PKGS:
        c = clusters[pkg]
        pos = _pos(c)
        prim[pkg] = sorted({pos[c.servers[0].cluster.shard_owners("i", s)[0]]
                            for s in range(N_SHARDS)})
    assert prim["torch"] == prim["jax"]
    for n in prim["torch"]:
        srv = clusters["torch"].servers[n]
        calls = srv.executor.stats.histogram_summary("query_seconds")
        assert sum(v["count"] for v in calls.values()) > 0


def test_each_node_has_its_own_plane_cache(clusters):
    """Nodes sharing one process (and, on a card, one device) each serve
    through their own executor: their own plane cache and budget."""
    srvs = clusters["torch"].servers
    assert len({id(s.executor.planes) for s in srvs}) == len(srvs)
    for s in srvs:
        assert s.executor.planes.budget == s.cfg.plane_budget_bytes
        assert s.api.cluster is s.cluster


def _non_owner(c, index, shard):
    owners = c.servers[0].cluster.shard_owners(index, shard)
    return next(i for i, s in enumerate(c.servers)
                if s.cluster.node_id not in owners), owners


def test_replicated_writes_land_on_both_replicas(clusters):
    seen = {}
    for pkg in PKGS:
        c = clusters[pkg]
        shard = 2
        via, owners = _non_owner(c, "w", shard)
        cl = _client(c.servers[via])
        assert cl.query("w", f"Set({shard * SW + 17}, f=1)") == [True]
        assert cl.query("w", f"Set({shard * SW + 18}, f=1)") == [True]
        assert cl.query("w", f"Clear({shard * SW + 18}, f=1)") == [True]
        rng = np.random.default_rng(3)
        cols = (shard * SW + rng.choice(SW, 4096, replace=False)).tolist()
        rows = rng.integers(2, 6, 4096).tolist()
        assert cl.import_bits("w", "f", rowIDs=rows, columnIDs=cols) > 0
        want = sorted({r * SW + (col % SW) for r, col in zip(rows, cols)}
                      | {1 * SW + 17})
        for n, srv in enumerate(c.servers):
            got = _positions(srv, "w", "f", shard)
            if srv.cluster.node_id in owners:
                assert got == want, (pkg, n)
            else:
                assert got == [], (pkg, n)
        seen[pkg] = [_positions(s, "w", "f", shard) for s in c.servers]
        assert cl.query("w", "Count(Row(f=1))") == [1]
    assert seen["jax"] == seen["torch"]


def _await(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(what)


def _http(base, path, body=b"", method="POST"):
    req = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_hinted_handoff_and_replay(clusters, monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    for mod in (jhints, thints):
        monkeypatch.setattr(mod, "time", clock)
    hint_bytes, refusals, replayed, windows = {}, {}, {}, {}
    for pkg in PKGS:
        c = clusters[pkg]
        victim = c.servers[2]
        vid = victim.cluster.node_id
        vcfg = victim.cfg
        victim.close()
        alive = c.servers[:2]
        _await(lambda: all(vid not in s.cluster.alive_ids()
                           for s in alive), what="victim suspect")
        cl = _client(alive[0])
        vshards = [s for s in range(N_SHARDS)
                   if vid in alive[0].cluster.shard_owners("h", s)]
        assert vshards
        for s in range(N_SHARDS):
            assert cl.query("h", f"Set({s * SW + 11}, f=1)") == [True]
        col = vshards[0] * SW + 11
        assert cl.query("h", f"Clear({col}, f=1)") == [True]
        cl.import_bits("h", "f", rowIDs=[2] * 20,
                       columnIDs=[vshards[0] * SW + 100 + i
                                  for i in range(20)])
        wh = cl.write_health()
        assert wh["hintBacklogOps"] >= 3
        assert {p["id"] for p in wh["peers"]} == {vid}
        hdir = os.path.join(alive[0].holder.path, "_hints")
        hint_bytes[pkg] = [open(os.path.join(hdir, n), "rb").read()
                           for n in sorted(os.listdir(hdir))
                           if n.endswith(".hints")]
        # past hint_max_age a Clear is refused loudly
        board = alive[0].cluster.hints
        board.max_age = 5.0
        clock.time = lambda: 1.7e9 + 10.0
        st, hdrs, body = _http(
            f"http://127.0.0.1:{alive[0].http.address[1]}",
            "/index/h/query", f"Clear({col}, f=1)".encode())
        clock.time = lambda: 1.7e9
        board.max_age = 300.0
        refusals[pkg] = (st, hdrs.get("Retry-After"),
                         json.loads(_norm(body.decode(), c)))
        # the node comes back: its hints replay, in order
        back = MAKE[pkg][0](vcfg).open()
        c.servers[2] = back
        c.await_membership(3)
        for s in alive:
            s.cluster._drain_hints(vid)
        _await(lambda: all(s.cluster.hints.pending_ops() == 0
                           for s in alive), what="hints drained")
        c.await_state("NORMAL")
        # the next heartbeats tell every node the backlog is gone; until
        # then AAE defers syncs with the hinted node
        _await(lambda: not any(s.cluster.hinted_peers() for s in c.servers),
               what="no hinted peers")
        replayed[pkg] = [_positions(back, "h", "f", s)
                         for s in range(N_SHARDS)]
        for s in vshards:
            other = next(x for x in alive if x.cluster.node_id
                         in back.cluster.shard_owners("h", s))
            assert replayed[pkg][s] == _positions(other, "h", "f", s)
        assert SW + col % SW not in replayed[pkg][vshards[0]]
        with open(os.path.join(back.holder.path,
                               "_hints_applied.log"), "rb") as f:
            windows[pkg] = f.read()
    assert hint_bytes["torch"] == hint_bytes["jax"] and hint_bytes["jax"]
    assert refusals["torch"] == refusals["jax"]
    assert refusals["torch"][0] == 503
    assert refusals["torch"][2]["writeUnavailable"] == {
        "op": "Clear", "replica": "<node2>", "reason": "hint_overflow"}
    assert replayed["torch"] == replayed["jax"]
    assert windows["torch"] == windows["jax"] and windows["jax"]


def test_aae_repairs_diverged_replica(clusters):
    blocks, counts = {}, {}
    for pkg in PKGS:
        c = clusters[pkg]
        cl = _client(c.servers[0])
        cols = [s * SW + 5 + s for s in range(N_SHARDS)]
        cl.import_bits("ae", "f", rowIDs=[1] * N_SHARDS, columnIDs=cols)
        owners = c.servers[0].cluster.shard_owners("ae", 0)
        src, dst = (c.server_for(o) for o in owners)
        # the receiver's plane is resident before the repair
        assert dst.executor.execute("ae", "Count(Row(f=1))",
                                    shards=[0]) == [1]
        if pkg == "torch":
            before = dst.executor.planes.stats()
        # diverge both ways, below the cluster (local writes only)
        _frag(src, "ae", "f", 0).set_bits(np.array([1, 1, 3], np.uint64),
                                          np.array([40, 41, 7], np.uint64))
        _frag(dst, "ae", "f", 0).set_bits(np.array([1], np.uint64),
                                          np.array([900], np.uint64))
        st, _, body = _http(f"http://127.0.0.1:{src.http.address[1]}",
                            "/internal/aae/run", b"{}")
        assert st == 200 and json.loads(body)["repaired"] > 0
        counts[pkg] = [s.executor.execute("ae", "Count(Row(f=1))",
                                          shards=[0])
                       for s in (src, dst)]
        assert counts[pkg] == [[4], [4]]
        if pkg == "torch":
            # the merged bits reached the resident plane by its journal
            merged = dst.executor.planes.stats()
            assert (merged["incrementalRefreshes"]
                    > before["incrementalRefreshes"])
            assert merged["misses"] == before["misses"]
        fs, fd = _frag(src, "ae", "f", 0), _frag(dst, "ae", "f", 0)
        assert fs.blocks() == fd.blocks()
        assert fs.positions().tolist() == fd.positions().tolist()
        blocks[pkg] = fs.blocks()
        # a quarantined copy is rebuilt from its replica
        sh = dst.holder.storage_health
        fd.set_bits(np.array([6], np.uint64), np.array([1], np.uint64))
        entry = sh.quarantine(fd.path, "snapshot", "damaged in a test")
        assert sh.is_quarantined(fd.path)
        assert dst.cluster.repair_quarantined(entry) is True
        assert not sh.is_quarantined(fd.path)
        assert fd.positions().tolist() == fs.positions().tolist()
        assert dst.executor.execute("ae", "Count(Row(f=1))",
                                    shards=[0]) == [4]
        if pkg == "torch":
            # a wholesale rebuild leaves a gap: the plane was built anew
            assert dst.executor.planes.stats()["misses"] > merged["misses"]
    assert blocks["torch"] == blocks["jax"]
    assert counts["torch"] == counts["jax"]


def test_blocks_checksums_equal_across_packages(clusters):
    for shard in range(N_SHARDS):
        for n in range(3):
            j = _frag(clusters["jax"].servers[n], "i", "f", shard)
            t = _frag(clusters["torch"].servers[n], "i", "f", shard)
            assert (j is None) == (t is None)
            if j is not None:
                assert t.blocks() == j.blocks()
                for b in j.blocks():
                    assert (t.block_positions(b).tolist()
                            == j.block_positions(b).tolist())


def test_resize_on_join_abort_and_removal(clusters):
    before = {pkg: _client(clusters[pkg].servers[0]).query("i", READS[1])
              for pkg in PKGS}
    placed, statuses = {}, {}
    for pkg in PKGS:
        c = clusters[pkg]
        server_cls, make_cfg, _ = MAKE[pkg]
        seed = c.servers[0].cluster.node_id
        late = server_cls(make_cfg(3, c.base, seed, c.ports[3])).open()
        c.servers.append(late)
        c.await_membership(4)
        _await(lambda: all(len(s.cluster.placement_ids) == 4
                           for s in c.servers), what="placement of 4")
        c.await_state("NORMAL")
        moved = [s for s in range(N_SHARDS)
                 if late.cluster.node_id
                 in late.cluster.shard_owners("i", s)]
        assert moved
        for s in moved:
            assert _positions(late, "i", "f", s)
        placed[pkg] = moved
        for srv in c.servers:
            assert _client(srv).query("i", READS[1]) == before[pkg]
        coord = next(s for s in c.servers if s.cluster.is_coordinator())
        other = next(s for s in c.servers if s is not coord)
        statuses[pkg] = [
            _http(f"http://127.0.0.1:{s.http.address[1]}",
                  "/internal/resize/abort", b"{}")[0]
            for s in (coord, other)]
        c.await_state("NORMAL")
        st, _, body = _http(f"http://127.0.0.1:{coord.http.address[1]}",
                            f"/cluster/node/{late.cluster.node_id}",
                            method="DELETE")
        assert st == 200, body
        c.servers.remove(late)
        _await(lambda: all(len(s.cluster.placement_ids) == 3
                           for s in c.servers), what="placement of 3")
        c.await_state("NORMAL")
        late.close()
        for srv in c.servers:
            assert _client(srv).query("i", READS[1]) == before[pkg]
            for s in range(N_SHARDS):
                if srv.cluster.node_id in srv.cluster.shard_owners("i", s):
                    assert _positions(srv, "i", "f", s)
    assert placed["torch"] == placed["jax"]
    assert statuses["torch"] == statuses["jax"] == [200, 409]
    assert before["torch"] == before["jax"]


def test_cluster_metrics_text(clusters):
    snaps = {
        "n1": {"counters": {"hint_appended_total": [
                   {"labels": {"peer": "n2"}, "value": 3}]},
               "gauges": {"peer_breaker_state": [
                   {"labels": {"peer": "n2"}, "value": 2}]},
               "histograms": {"query_seconds": {
                   "buckets": [0.1, 1.0],
                   "series": [{"labels": {"call": "Count"},
                               "counts": [1, 2, 0], "sum": 1.5,
                               "count": 3}]}}},
        "n2": {"counters": {}, "gauges": {},
               "histograms": {"query_seconds": {
                   "buckets": [0.1, 1.0],
                   "series": [{"labels": {"call": "Count"},
                               "counts": [0, 1, 1], "sum": 2.5,
                               "count": 2}]}}},
        "n3": {"counters": {}, "gauges": {},
               "histograms": {"query_seconds": {
                   "buckets": [0.5],
                   "series": [{"labels": {"call": "TopN"},
                               "counts": [1, 0], "sum": 0.2,
                               "count": 1}]}}}}
    for stale in ([], ["n4"]):
        assert (tmetrics.render_cluster_metrics(snaps, stale)
                == jmetrics.render_cluster_metrics(snaps, stale))
    srv = clusters["torch"].servers[0]
    st, hdrs, body = _http(f"http://127.0.0.1:{srv.http.address[1]}",
                           "/metrics/cluster", method="GET")
    text = body.decode()
    assert st == 200
    for s in clusters["torch"].servers:
        assert (f'cluster_metrics_node_up{{node="{s.cluster.node_id}"}} 1'
                in text)
    assert "cluster_metrics_stale_nodes 0" in text
    assert "hint_appended_total" in text
    st, _, body = _http(f"http://127.0.0.1:{srv.http.address[1]}",
                        "/status/cluster", method="GET")
    doc = json.loads(body)
    assert st == 200 and doc["staleNodes"] == []
    assert sorted(doc["nodes"]) == sorted(
        s.cluster.node_id for s in clusters["torch"].servers)
    assert doc["coordinator"] == srv.cluster.coordinator_id()


def test_fragments_byte_equal_after_the_scenario(clusters):
    """Closing compacts every fragment: each node's snapshots are equal
    to the reference node's at the same position, byte for byte."""
    trees = {}
    for pkg in PKGS:
        c = clusters[pkg]
        for s in c.servers:
            s.close()
        files = {}
        for n in range(3):
            root = os.path.join(c.base, f"node{n}")
            for dirpath, _, names in os.walk(root):
                if os.sep + "fragments" not in dirpath:
                    continue
                for name in names:
                    if name.isdigit():
                        path = os.path.join(dirpath, name)
                        with open(path, "rb") as f:
                            files[os.path.relpath(path, c.base)] = f.read()
        trees[pkg] = files
    assert trees["torch"].keys() == trees["jax"].keys()
    assert len(trees["jax"]) > 3 * N_SHARDS
    for k in trees["jax"]:
        assert trees["torch"][k] == trees["jax"][k], k
    # the snapshots hold what the scenario wrote (past the 20-byte frame)
    blob = next(b for k, b in trees["torch"].items()
                if k.startswith(os.path.join("node0", "i", "f", "")))
    assert len(troaring.deserialize(blob[20:])) > 0
