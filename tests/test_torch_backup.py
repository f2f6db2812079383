"""The port's backup and restore against ``pilosa_tpu.backup`` on the CPU.

- Every case of the reference's ``tests/test_backup.py``, run against the
  port: an online backup of a 3-node cluster while a writer runs, an
  incremental pass, an elastic restore into a 2-node cluster, replica
  fallback when a node dies mid-backup, digest checks, the fragment
  endpoint's headers, the bounded-memory download, ``import_roaring``'s
  restore semantics with a resident plane, the snapshot queue's drain,
  the storage block and the backup / restore counters, the manifest.
- Across packages, on 3-node clusters whose ports sort alike (so every
  shard has the same owners by position) and hold the same data: equal
  manifests once times and node ids are dropped, byte-equal archive
  files, equal per-fragment headers (body digest, generation, checksum),
  the same incremental transfer set, a JAX archive restored into a port
  cluster and a port archive into a JAX cluster answering as their
  sources, the legacy tar restored across packages both ways, the same
  ``DigestError`` text, and the CLI's ``backup`` / ``restore`` in both
  forms with the same exit codes and files.
"""

import glob
import hashlib
import json
import os
import shutil
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JHttp
from pilosa_tpu.api.client import Client as JClient
from pilosa_tpu.backup import BackupDriver as JBackup
from pilosa_tpu.backup import DigestError as JDigestError
from pilosa_tpu.backup import RestoreDriver as JRestore
from pilosa_tpu.cli import main as jmain
from pilosa_tpu.cli.config import Config as JConfig
from pilosa_tpu.server import PilosaTPUServer as JServer
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.testing import TestCluster as JTestCluster
from pilosa_tpu_torch.api import API, Server
from pilosa_tpu_torch.api.client import Client, ClientError
from pilosa_tpu_torch.backup import (BackupDriver, BackupError, DigestError,
                                     Manifest, ManifestError, RestoreDriver)
from pilosa_tpu_torch.cli import main as tmain
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.obs import Stats
from pilosa_tpu_torch.server import PilosaTPUServer as TServer
from pilosa_tpu_torch.store import Holder, roaring
from pilosa_tpu_torch.store.fragment import Fragment
from pilosa_tpu_torch.store.holder import SnapshotQueue
from pilosa_tpu_torch.testing import TestCluster as TTestCluster
from pilosa_tpu_torch.testing import free_ports, node_config, run_cluster
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
PKGS = ("jax", "torch")


@contextmanager
def fresh_node(path: str):
    """A single un-clustered port server over its own holder (restore
    targets, endpoint tests)."""
    holder = Holder(path).open()
    api = API(holder, Executor(holder, device="cpu"))
    server = Server(api, "127.0.0.1", 0).start()
    try:
        yield SimpleNamespace(
            holder=holder, api=api, server=server,
            port=server.address[1],
            client=Client("127.0.0.1", server.address[1]))
    finally:
        server.close()
        api.executor.close()
        holder.close()


@contextmanager
def fresh_jnode(path: str):
    """The reference's single un-clustered server."""
    holder = JHolder(path).open()
    api = JAPI(holder)
    server = JHttp(api, "127.0.0.1", 0).start()
    try:
        yield SimpleNamespace(
            holder=holder, api=api, server=server,
            port=server.address[1],
            client=JClient("127.0.0.1", server.address[1]))
    finally:
        server.close()
        holder.close()


FRESH = {"jax": fresh_jnode, "torch": fresh_node}


@pytest.fixture
def node(tmp_path):
    with fresh_node(str(tmp_path / "data")) as n:
        yield n


# ---------------------------------------------------------------------------
# the reference's cases, against the port
# ---------------------------------------------------------------------------


class TestOnlineClusterRoundTrip:
    N_ROWS = 3

    def _write(self, client, acked, row: int, col: int) -> None:
        client.query("bk", f"Set({col}, f={row})")
        acked.setdefault(row, set()).add(col)

    def test_backup_during_writes_restores_into_smaller_cluster(
            self, tmp_path):
        """3 nodes (replicas=2) -> archive -> fresh 2-node cluster.  The
        full backup runs beside a writer; a quiesced incremental pass
        catches the tail, so every target node answers the acked-write
        oracle exactly."""
        out = str(tmp_path / "arch")
        acked: dict[int, set[int]] = {}
        with run_cluster(3, str(tmp_path / "src"), replicas=2,
                         device="cpu") as src:
            c = src.client(0)
            c.create_index("bk")
            c.create_field("bk", "f")
            c.create_field("bk", "n",
                           {"type": "int", "min": -100, "max": 100000})
            for i in range(36):
                self._write(c, acked, i % self.N_ROWS,
                            (i * 74) % (3 * SW))
            bsi_cols = [5, SW + 2, 2 * SW + 9, 40, SW + 77]
            bsi_vals = [7, 60, 120, -3, 55]
            c.import_values("bk", "n", columnIDs=bsi_cols,
                            values=bsi_vals)

            # a writer in flight (odd columns, never colliding with the
            # first phase) while the full backup runs
            stop = threading.Event()
            wrote = threading.Event()

            def writer():
                k = 0
                while not stop.is_set():
                    self._write(c, acked, k % self.N_ROWS,
                                ((k * 74) + 1) % (3 * SW))
                    k += 1
                    if k >= 5:
                        wrote.set()
                    time.sleep(0.002)

            t = threading.Thread(target=writer)
            t.start()
            try:
                assert wrote.wait(10), "writer never got going"
                port = src.servers[0].http.address[1]
                res1 = BackupDriver("127.0.0.1", port, out,
                                    workers=3).run()
            finally:
                stop.set()
                t.join(10)
            assert res1["fragments"] == len(res1["transferred"])

            res2 = BackupDriver("127.0.0.1", port, out, workers=3,
                                incremental=True).run()
            assert res2["incremental"]
            assert set(res2["transferred"]) | set(res2["skipped"]) \
                == set(res1["transferred"])

            # one new bit on shard 0 re-transfers exactly the two shard-0
            # fragments it touches (f and the _exists row)
            used = set()
            for cols in acked.values():
                used |= {col for col in cols if col < SW}
            used |= {col for col in bsi_cols if col < SW}
            new_col = next(col for col in range(SW) if col not in used)
            self._write(c, acked, 10, new_col)
            res3 = BackupDriver("127.0.0.1", port, out, workers=3,
                                incremental=True).run()
            assert set(res3["transferred"]) == {
                "bk/f/standard/0", "bk/_exists/standard/0"}
            assert set(res3["skipped"]) == (
                set(res1["transferred"]) - set(res3["transferred"]))

            man = Manifest.load(out)
            assert set(man.fragments) == set(res1["transferred"])
            assert all(ent["sha256"] and ent["checksum"]
                       for ent in man.fragments.values())

            topn_src = c.query("bk", "TopN(f)")
            range_src = c.query("bk", "Row(n > 50)")
            sum_src = c.query("bk", "Sum(field=n)")
            assert set(range_src[0]["columns"]) == {
                col for col, v in zip(bsi_cols, bsi_vals) if v > 50}

        with run_cluster(2, str(tmp_path / "dst"), replicas=2,
                         device="cpu") as dst:
            rres = RestoreDriver(
                "127.0.0.1", dst.servers[0].http.address[1], out,
                workers=3).run()
            assert rres["fragments"] == len(man.fragments)
            assert rres["nodes"] == 2
            for i in range(2):
                c2 = dst.client(i)
                for row, cols in sorted(acked.items()):
                    got = c2.query(
                        "bk", f"Row(f={row})Count(Row(f={row}))")
                    assert set(got[0]["columns"]) == cols, \
                        f"node {i} row {row} diverges"
                    assert got[1] == len(cols)
                assert c2.query("bk", "TopN(f)") == topn_src
                assert c2.query("bk", "Row(n > 50)") == range_src
                assert c2.query("bk", "Sum(field=n)") == sum_src

            # a second run meets the indexes the first created
            with pytest.raises(BackupError, match="fresh"):
                RestoreDriver("127.0.0.1",
                              dst.servers[0].http.address[1], out).run()

    def test_node_death_mid_backup_falls_back_to_replicas(self, tmp_path):
        """A non-entry node's HTTP surface dies after the first fragment;
        with replicas=2 every fragment has a surviving holder, so the
        backup completes and restores to the acked oracle."""
        out = str(tmp_path / "arch")
        acked: dict[int, set[int]] = {}
        with run_cluster(3, str(tmp_path / "src"), replicas=2,
                         device="cpu") as src:
            c = src.client(0)
            c.create_index("bk")
            c.create_field("bk", "f")
            for i in range(30):
                self._write(c, acked, i % self.N_ROWS,
                            (i * 119) % (3 * SW))
            victim = src.servers[1]
            killed = threading.Event()

            def on_fragment(key):
                if not killed.is_set():
                    killed.set()
                    victim.http.close()  # the node dies mid-backup

            port = src.servers[0].http.address[1]
            res = BackupDriver("127.0.0.1", port, out, workers=1,
                               on_fragment=on_fragment).run()
            assert killed.is_set()
            man = Manifest.load(out)
            assert len(man.fragments) == res["fragments"] > 0

        with fresh_node(str(tmp_path / "dst")) as dst:
            RestoreDriver("127.0.0.1", dst.port, out).run()
            for row, cols in sorted(acked.items()):
                got = dst.client.query(
                    "bk", f"Row(f={row})Count(Row(f={row}))")
                assert set(got[0]["columns"]) == cols
                assert got[1] == len(cols)


class TestArchiveIntegrity:
    def test_corrupted_archive_file_fails_digest_verification(
            self, node, tmp_path):
        c = node.client
        c.create_index("i")
        c.create_field("i", "f")
        c.query("i", "Set(10, f=1)Set(2000, f=2)")
        out = str(tmp_path / "arch")
        BackupDriver("127.0.0.1", node.port, out).run()
        frag_file = os.path.join(out, "fragments", "i", "f", "standard",
                                 "0")
        blob = bytearray(open(frag_file, "rb").read())
        blob[-1] ^= 0xFF
        open(frag_file, "wb").write(bytes(blob))
        with fresh_node(str(tmp_path / "dst")) as dst:
            with pytest.raises(DigestError, match="sha256 mismatch"):
                RestoreDriver("127.0.0.1", dst.port, out).run()
            # the target was never touched
            assert dst.client.schema() == []

    def test_fragment_endpoint_serves_digest_and_generation(self, node):
        c = node.client
        c.create_index("i")
        c.create_field("i", "f")
        c.query("i", "Set(10, f=1)")

        class Sink:
            def __init__(self):
                self.chunks = []

            def write(self, b):
                self.chunks.append(bytes(b))
                return len(b)

        sink = Sink()
        headers = c.download("/internal/backup/fragment/i/f/standard/0",
                             sink)
        body = b"".join(sink.chunks)
        assert int(headers["Content-Length"]) == len(body)
        assert headers["X-Content-SHA256"] \
            == hashlib.sha256(body).hexdigest()
        assert int(headers["X-Pilosa-Generation"]) >= 1
        assert roaring.deserialize(body).tolist() == [1 * SW + 10]

    def test_download_streams_in_bounded_chunks(self, node):
        c = node.client
        c.create_index("i")
        c.create_field("i", "f")
        cols = list(range(0, 50000, 7))  # a bitmap container: ~8 KB
        c.import_bits("i", "f", rowIDs=[1] * len(cols), columnIDs=cols)

        class Sink:
            def __init__(self):
                self.sizes = []
                self.h = hashlib.sha256()

            def write(self, b):
                self.sizes.append(len(b))
                self.h.update(b)
                return len(b)

        sink = Sink()
        headers = c.download(
            "/internal/backup/fragment/i/f/standard/0", sink,
            chunk_size=64)
        assert max(sink.sizes) <= 64
        assert len(sink.sizes) > 1
        assert sink.h.hexdigest() == headers["X-Content-SHA256"]

    def test_download_http_error_raises_client_error(self, node):
        class Sink:
            def write(self, b):
                raise AssertionError("error bodies must not hit sinks")

        with pytest.raises(ClientError):
            node.client.download(
                "/internal/backup/fragment/nope/f/standard/0", Sink())

    def test_quarantined_fragment_refused_with_503(self, node):
        """The quarantine gate: an archive never captures a corrupt copy
        (the driver then falls back to a replica)."""
        c = node.client
        c.create_index("i")
        c.create_field("i", "f")
        c.query("i", "Set(10, f=1)")
        frag = node.holder.index("i").field("f").view("standard") \
            .fragment(0)
        node.holder.storage_health.quarantine(frag.path, "snapshot",
                                              "damaged in a test")
        with pytest.raises(ClientError) as ei:
            c._do("GET", "/internal/backup/fragment/i/f/standard/0")
        assert ei.value.status == 503
        assert "back up from a replica" in str(ei.value)


class TestImportRoaringRestoreSemantics:
    def test_generation_bump_idempotent_repush_and_clear(self, tmp_path):
        frag = Fragment(str(tmp_path / "0"), 0).open()
        positions = np.array([1 * SW + 10, 1 * SW + 11, 2 * SW + 7],
                             np.uint64)
        blob = roaring.serialize(positions)
        assert frag.import_roaring(blob) == 3
        g1 = frag.generation
        assert g1 >= 1
        # an idempotent re-push: no double count, no invalidation
        assert frag.import_roaring(blob) == 0
        assert frag.generation == g1
        assert frag.import_roaring(blob, clear=True) == 3
        g2 = frag.generation
        assert g2 > g1
        assert frag.row_ids() == []
        assert frag.import_roaring(blob, clear=True) == 0
        assert frag.generation == g2
        frag.close()

    def test_restore_push_invalidates_cached_planes(self, tmp_path):
        """A restore push lands through ``import_roaring`` (the merge
        route's union): the resident plane answers the pushed bits
        (through its journal or a rebuild), never the pre-restore
        count."""
        holder = Holder(str(tmp_path / "d")).open()
        idx = holder.create_index("i", track_existence=False)
        idx.create_field("f")
        frag = idx.field("f").view("standard", create=True) \
            .fragment(0, create=True)
        frag.set_bits(np.array([1], np.uint64), np.array([10], np.uint64))
        ex = Executor(holder, device="cpu")
        try:
            assert ex.execute("i", "Count(Row(f=1))") == [1]  # resident
            gen_before = frag.generation
            more = roaring.serialize(
                np.array([1 * SW + 20, 1 * SW + 21], np.uint64))
            assert frag.import_roaring(more) == 2
            assert frag.generation > gen_before
            assert ex.execute("i", "Count(Row(f=1))") == [3]
            assert frag.import_roaring(more) == 0
            assert ex.execute("i", "Count(Row(f=1))") == [3]
        finally:
            ex.close()
            holder.close()


class TestSnapshotQueueDrain:
    def test_close_drains_backlog_instead_of_dropping_it(self):
        done = []
        ready = threading.Event()

        class FakeFrag:
            path = "fake"

            def __init__(self, i):
                self.i = i
                self.op_n = 0

            def maybe_snapshot(self):
                ready.wait(5)      # hold the worker so a backlog forms
                time.sleep(0.005)
                done.append(self.i)

        q = SnapshotQueue()
        for i in range(6):
            q.submit(FakeFrag(i))
        ready.set()
        q.close()
        assert sorted(done) == list(range(6)), \
            "close() dropped queued compactions"

    def test_clean_shutdown_leaves_no_oplog_tail(self, tmp_path):
        data = str(tmp_path / "d")
        h = Holder(data).open()
        idx = h.create_index("i", track_existence=False)
        idx.create_field("f")
        frag = idx.field("f").view("standard", create=True) \
            .fragment(0, create=True)
        frag.max_op_n = 1  # every write passes the threshold
        for k in range(4):
            frag.set_bits(np.array([1], np.uint64),
                          np.array([10 + k], np.uint64))
        h.close()
        for oplog in glob.glob(f"{data}/**/*.oplog", recursive=True):
            assert os.path.getsize(oplog) == 0, \
                f"{oplog} left a tail to replay"
        h2 = Holder(data).open()
        frag2 = h2.index("i").field("f").view("standard").fragment(0)
        assert frag2.op_n == 0
        assert (frag2.positions() - np.uint64(SW)).tolist() \
            == [10, 11, 12, 13]
        h2.close()


class TestStorageObservability:
    def test_status_storage_block_and_metrics_gauges(self, tmp_path):
        holder = Holder(str(tmp_path / "data")).open()
        api = API(holder, Executor(holder, device="cpu"))
        server = Server(api, "127.0.0.1", 0, stats=Stats()).start()
        try:
            c = Client("127.0.0.1", server.address[1])
            c.create_index("i")
            c.create_field("i", "f")
            c.query("i", "Set(10, f=1)Set(11, f=2)")
            st = c.status()["storage"]
            assert st["fragmentCount"] >= 2   # f and _exists
            assert st["oplogBytes"] > 0       # the tail not compacted
            text = c.metrics_text()
            assert "\noplog_bytes " in text or \
                text.startswith("oplog_bytes ")
            assert "fragment_count" in text
            assert "snapshot_bytes" in text
        finally:
            server.close()
            api.executor.close()
            holder.close()

    def test_backup_restore_metrics_counters(self, node, tmp_path):
        """backup_bytes_total counts served images; restore pushes marked
        X-Pilosa-Restore count restore_bytes_total."""
        c = node.client
        c.create_index("i")
        c.create_field("i", "f")
        c.query("i", "Set(10, f=1)")
        stats = Stats()
        node.server.httpd.stats = stats
        out = str(tmp_path / "arch")
        BackupDriver("127.0.0.1", node.port, out).run()
        counters = stats.snapshot()["counters"]
        assert sum(counters["backup_bytes_total"].values()) > 0
        with fresh_node(str(tmp_path / "dst")) as dst:
            rstats = Stats()
            dst.server.httpd.stats = rstats
            RestoreDriver("127.0.0.1", dst.port, out).run()
            rc = rstats.snapshot()["counters"]
            assert sum(rc["restore_bytes_total"].values()) > 0


class TestManifest:
    def test_diff_classifies_changed_unchanged_removed(self):
        old = Manifest()
        old.fragments = {
            "i/f/standard/0": {"checksum": "aa", "file": "x"},
            "i/f/standard/1": {"checksum": "bb", "file": "y"},
            "i/f/standard/2": {"checksum": "cc", "file": "z"},
        }
        new = Manifest()
        new.fragments = {
            "i/f/standard/0": {"checksum": "aa", "file": "x"},
            "i/f/standard/1": {"checksum": "b2", "file": "y"},
            "i/f/standard/3": {"checksum": "dd", "file": "w"},
        }
        d = new.diff(old)
        assert d["unchanged"] == ["i/f/standard/0"]
        assert d["changed"] == ["i/f/standard/1", "i/f/standard/3"]
        assert d["removed"] == ["i/f/standard/2"]
        assert new.diff(None)["changed"] == sorted(new.fragments)

    def test_version_gate_and_malformed_manifest(self, tmp_path):
        out = str(tmp_path)
        with pytest.raises(ManifestError, match="no manifest"):
            Manifest.load(out)
        path = os.path.join(out, "manifest.json")
        with open(path, "w") as f:
            json.dump({"formatVersion": 99}, f)
        with pytest.raises(ManifestError, match="format"):
            Manifest.load(out)
        with open(path, "w") as f:
            f.write("not json")
        with pytest.raises(ManifestError, match="malformed"):
            Manifest.load(out)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

DRIVERS = {"jax": (JBackup, JRestore), "torch": (BackupDriver,
                                                 RestoreDriver)}
N_SHARDS = 3


def _jconfig(i, base, seed, port, replicas=2):
    return JConfig(bind=f"127.0.0.1:{port}", data_dir=f"{base}/node{i}",
                   seeds=[seed] if seed else [], replicas=replicas,
                   cluster_enabled=True, heartbeat_interval=0.5,
                   anti_entropy_interval=0.0, mesh=False)


def _tconfig(i, base, seed, port, replicas=2):
    return node_config(i, base, seed, port=port, replicas=replicas,
                       heartbeat=0.5, device="cpu")


MAKE = {"jax": (JServer, _jconfig, JTestCluster),
        "torch": (TServer, _tconfig, TTestCluster)}


def _boot(pkg, base, ports, replicas=2):
    server_cls, make_cfg, cluster_cls = MAKE[pkg]
    servers, seed = [], None
    try:
        for i, port in enumerate(ports):
            srv = server_cls(make_cfg(i, base, seed, port,
                                      replicas)).open()
            servers.append(srv)
            seed = seed or srv.cluster.node_id
        c = cluster_cls(servers)
        c.await_membership(len(ports))
        c.await_state("NORMAL")
    except BaseException:
        _close(servers)
        raise
    return c


def _close(servers):
    for s in servers:
        try:
            s.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


def _port(c, i=0):
    return c.servers[i].http.address[1]


def _data():
    """Seeded bits of f, values of n, keyed rows of s, and column
    attributes, over N_SHARDS shards."""
    rng = np.random.default_rng(15)
    cols = np.concatenate([s * SW + rng.choice(6000, 90, replace=False)
                           for s in range(N_SHARDS)])
    rows = rng.integers(0, 5, len(cols))
    n_cols = rng.choice(cols, 60, replace=False)
    n_vals = rng.integers(-50, 900, len(n_cols))
    s_cols = rng.choice(cols, 40, replace=False)
    s_keys = [("red", "green", "blue")[i]
              for i in rng.integers(0, 3, len(s_cols))]
    return dict(f=(rows, cols), n=(n_cols, n_vals), s=(s_keys, s_cols))


def _load(client, d):
    client.create_index("bk")
    client.create_field("bk", "f")
    client.create_field("bk", "n", {"type": "int", "min": -50,
                                    "max": 1000})
    client.create_field("bk", "s", {"keys": True})
    rows, cols = d["f"]
    client.import_bits("bk", "f", rowIDs=[int(r) for r in rows],
                       columnIDs=[int(c) for c in cols])
    n_cols, n_vals = d["n"]
    client.import_values("bk", "n", columnIDs=[int(c) for c in n_cols],
                         values=[int(v) for v in n_vals])
    s_keys, s_cols = d["s"]
    client.import_bits("bk", "s", rowKeys=s_keys,
                       columnIDs=[int(c) for c in s_cols])
    client.query("bk", "SetColumnAttrs(7, color=\"teal\")"
                       "SetRowAttrs(f, 2, weight=3)")


READS = ["Count(Row(f=1))Count(Row(f=3))", "TopN(f)", "Row(n > 400)",
         "Sum(field=n)", "Count(Row(s=\"green\"))", "Row(f=2)",
         "TopN(s)"]


def _answers(client) -> list:
    return [client.query("bk", q) for q in READS]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A loaded 3-node cluster of each package (replicas = 2) on ports
    that ascend alike, so each shard's owners sit at the same positions;
    and each one's full archive."""
    ports = free_ports(6)
    base = tmp_path_factory.mktemp("bk_sources")
    d = _data()
    out = {}
    try:
        for pkg, pp in (("jax", ports[:3]), ("torch", ports[3:])):
            c = _boot(pkg, str(base / pkg), pp)
            out[pkg] = c
            cl = c.client(0)
            _load(cl, d)
            c.answers = _answers(cl)
            c.archive = str(base / f"{pkg}_arch")
            c.result = DRIVERS[pkg][0]("127.0.0.1", _port(c), c.archive,
                                       workers=3).run()
        yield out
    finally:
        for c in out.values():
            _close(c.servers)


def _norm_manifest(path, cluster) -> dict:
    """A manifest's JSON with its time fields (the schema's creation
    times among them) dropped and node ids by position."""
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    ids = {nid: f"node{i}" for i, nid in enumerate(sorted(
        s.cluster.node_id for s in cluster.servers))}
    for k in ("createdAt", "incrementalOf", "placementVersion"):
        m.pop(k)
    for idx in m["schema"]:
        idx.pop("createdAt")
        for f in idx["fields"]:
            f.pop("createdAt")
    m["nodes"] = [ids[n] for n in m["nodes"]]
    return m


def _files(path) -> dict:
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            out[os.path.relpath(full, path)] = open(full, "rb").read()
    return out


def test_sources_answer_alike(sources):
    assert sources["torch"].answers == sources["jax"].answers


def test_archives_equal_across_packages(sources):
    j, t = sources["jax"], sources["torch"]
    assert _norm_manifest(t.archive, t) == _norm_manifest(j.archive, j)
    tf, jf = _files(t.archive), _files(j.archive)
    assert set(tf) == set(jf)
    for rel in sorted(jf):
        if rel != "manifest.json":
            assert tf[rel] == jf[rel], rel
    # the fragment route's headers and bodies, fragment by fragment on
    # the same node position
    man = Manifest.load(t.archive)
    for key, ent in sorted(man.fragments.items()):
        path = (f"/internal/backup/fragment/{ent['index']}/"
                f"{ent['field']}/{ent['view']}/{ent['shard']}")
        got = {}
        for pkg, c in sources.items():
            owner = c.servers[0].cluster.shard_owners(ent["index"],
                                                      ent["shard"])[0]
            pos = sorted(s.cluster.node_id for s in c.servers).index(owner)
            srv = c.server_for(owner)
            cl = (Client if pkg == "torch" else JClient)(
                "127.0.0.1", srv.http.address[1])
            chunks = []

            class Sink:
                def write(self, b):
                    chunks.append(bytes(b))
                    return len(b)

            h = cl.download(path, Sink())
            got[pkg] = (pos, b"".join(chunks), h["Content-Length"],
                        h["X-Content-SHA256"], h["X-Pilosa-Generation"],
                        h["X-Pilosa-Checksum"])
        assert got["torch"] == got["jax"], key


def test_incremental_transfers_the_same_set(sources, tmp_path):
    sets = {}
    for pkg, c in sources.items():
        arch = str(tmp_path / pkg)
        shutil.copytree(c.archive, arch)
        c.client(0).query("bk", f"Set({SW + 4001}, f=4)")
        res = DRIVERS[pkg][0]("127.0.0.1", _port(c), arch, workers=2,
                              incremental=True).run()
        assert res["incremental"]
        sets[pkg] = (res["transferred"], res["skipped"])
        c.client(0).query("bk", f"Clear({SW + 4001}, f=4)")
    assert sets["torch"] == sets["jax"]
    assert set(sets["torch"][0]) == {"bk/f/standard/1",
                                     "bk/_exists/standard/1"}


@pytest.mark.parametrize("src", PKGS)
def test_restore_across_packages(sources, tmp_path, src):
    """One package's archive restored into a fresh 2-node cluster of the
    other answers as the source did, on every node."""
    dst = "torch" if src == "jax" else "jax"
    c = _boot(dst, str(tmp_path / dst), free_ports(2))
    try:
        res = DRIVERS[dst][1]("127.0.0.1", _port(c),
                              sources[src].archive, workers=2).run()
        assert res["fragments"] == sources[src].result["fragments"]
        for i in range(2):
            assert _answers(c.client(i)) == sources[src].answers, i
        assert c.client(1).query("bk", "Options(Row(f=1), "
                                       "columnAttrs=true)") \
            == sources[src].client(0).query(
                "bk", "Options(Row(f=1), columnAttrs=true)")
    finally:
        _close(c.servers)


@pytest.mark.parametrize("src", PKGS)
def test_legacy_tar_across_packages(tmp_path, src):
    """``GET /internal/backup`` of one package's node restored through
    ``POST /internal/restore`` into the other's fresh node."""
    dst = "torch" if src == "jax" else "jax"
    d = _data()
    with FRESH[src](str(tmp_path / "src")) as a:
        _load(a.client, d)
        want = _answers(a.client)
        blob = a.client._do("GET", "/internal/backup")
    with FRESH[dst](str(tmp_path / "dst")) as b:
        b.client._do("POST", "/internal/restore", blob,
                     content_type="application/x-tar")
        assert _answers(b.client) == want
        # a second restore meets a holder that is not empty
        with pytest.raises(Exception) as ei:
            b.client._do("POST", "/internal/restore", blob,
                         content_type="application/x-tar")
        assert getattr(ei.value, "status", None) == 409


def test_restore_tar_drops_cached_state(node, tmp_path):
    """``restore_tar`` opens what the tar holds, and no plane, plan or
    key store cached before it answers for the restored index."""
    d = _data()
    with fresh_node(str(tmp_path / "src")) as a:
        _load(a.client, d)
        want = _answers(a.client)
        blob = a.api.backup_tar()
    c = node.client
    # the same index name held other bits before: planes and plans of
    # "bk" were cached, then the index was deleted
    c.create_index("bk")
    c.create_field("bk", "f")
    c.query("bk", "Set(1, f=1)Set(5, f=3)")
    assert c.query("bk", "Count(Row(f=1))Count(Row(f=3))") == [1, 1]
    c.delete_index("bk")
    node.api.restore_tar(blob)
    assert node.api.executor.planes.stats()["entries"] == 0
    assert _answers(c) == want


def test_digest_error_text_equal(sources, tmp_path):
    texts = {}
    for pkg, c in sources.items():
        arch = str(tmp_path / pkg)
        shutil.copytree(c.archive, arch)
        path = os.path.join(arch, "fragments", "bk", "f", "standard", "2")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0x01
        open(path, "wb").write(bytes(blob))
        with FRESH[pkg](str(tmp_path / f"dst_{pkg}")) as n:
            err = (JDigestError if pkg == "jax" else DigestError)
            with pytest.raises(err) as ei:
                DRIVERS[pkg][1]("127.0.0.1", n.port, arch).run()
            assert n.client.schema() == []
        texts[pkg] = str(ei.value)
    assert texts["torch"] == texts["jax"]
    assert "sha256 mismatch for 'fragments/bk/f/standard/2'" \
        in texts["torch"]


def test_cli_backup_and_restore_both_forms(tmp_path, capsys):
    """The CLI's ``backup -o DIR`` / ``restore DIR`` and the ``.tar``
    forms, each package's against its own node: the same exit codes, the
    same archive files, and restored nodes answering as their sources."""
    d = _data()
    mods = {"jax": jmain, "torch": tmain}
    codes, archives, answers = {}, {}, {}
    for pkg in PKGS:
        mod = mods[pkg]
        with FRESH[pkg](str(tmp_path / f"src_{pkg}")) as a:
            _load(a.client, d)
            answers[pkg] = _answers(a.client)
            bind = ["--bind", f"127.0.0.1:{a.port}"]
            arch = str(tmp_path / f"arch_{pkg}")
            tar = str(tmp_path / f"{pkg}.tar")
            codes[pkg] = [mod.main(["backup", *bind, "-o", arch,
                                    "--workers", "2"]),
                          mod.main(["backup", *bind, "-o", arch,
                                    "--incremental"]),
                          mod.main(["backup", *bind, "-o", tar])]
            err = capsys.readouterr().err.splitlines()
            assert err[0].startswith("backup: ") and err[2].startswith(
                f"wrote {os.path.getsize(tar)} bytes to {tar}"), err
        with FRESH[pkg](str(tmp_path / f"dir_{pkg}")) as b:
            codes[pkg].append(mod.main(
                ["restore", "--bind", f"127.0.0.1:{b.port}", arch]))
            assert _answers(b.client) == answers[pkg]
            # restoring again into the same node fails: not fresh
            codes[pkg].append(mod.main(
                ["restore", "--bind", f"127.0.0.1:{b.port}", arch]))
        with FRESH[pkg](str(tmp_path / f"tar_{pkg}")) as b:
            codes[pkg].append(mod.main(
                ["restore", "--bind", f"127.0.0.1:{b.port}", tar]))
            assert _answers(b.client) == answers[pkg]
        err = capsys.readouterr().err.splitlines()
        assert err[0].startswith("restore: ")
        assert err[1].startswith("restore failed: restore target already "
                                 "has index(es) ['bk']")
        assert err[2] == "restored"
        files = _files(arch)
        files.pop("manifest.json")
        archives[pkg] = files
    assert codes["torch"] == codes["jax"] == [0, 0, 0, 0, 1, 0]
    assert archives["torch"] == archives["jax"]
    assert answers["torch"] == answers["jax"]
