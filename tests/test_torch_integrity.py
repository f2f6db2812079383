"""Storage integrity in the port against ``pilosa_tpu`` on the CPU.

One data directory written by the reference (three shards of one set, one
mutex, one int and one time field, from a seed with numpy) is copied per
package, damaged the same way, and opened by both:

- a corrupt snapshot quarantines its fragment at open (never the whole
  holder), which then serves what its op-log holds; a corrupt op-log
  record mid-file truncates the log at replay; both packages give the
  same ``storageHealth`` block (paths relative to the data directory),
  the same answers, the same 503 ``storageFault`` body for a write into
  the quarantined fragment and the same ``cli check`` output and exit
  code;
- ``ENOSPC`` through ``note_os_error`` flips the node read-only: the same
  507 ``writeUnavailable`` body, reads serving, and a probe recovers;
- the scrubber, on a live holder: a snapshot corrupted under a resident
  plane quarantines (the next Count leaves that shard's rows out, as the
  reference's does), a corrupt op-log record mid-file quarantines, a
  corrupt ``.dense`` sidecar is unlinked and counted, and a pass keeps to
  its bytes budget and scans the reference's bytes.

Every executor is closed, and the scrubber runs in the test's thread, so
no scrubber or probe thread outlives its test.
"""

import errno
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.cli import main as jmain
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.obs import Stats as JStats
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import health as jhealth
from pilosa_tpu.store.scrub import Scrubber as JScrubber
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.cli import main as tmain
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.obs import Stats as TStats
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import health as thealth
from pilosa_tpu_torch.store.scrub import Scrubber as TScrubber

SW = 1 << 20
N_SHARDS = 3
READS = ["Count(Row(f=0))", "Count(Row(f=1))", "Count(Row(f=4))",
         "Count(Row(g=1))", "Count(Row(g=2))", "TopN(f, n=5)",
         "Count(Row(m=1))", "Sum(field=n)", "Count(Row(n > 100))",
         "Count(Row(t=1, from='2020-01-01T00:00', to='2020-01-09T00:00'))"]


def _frag(root: str, field: str, shard: int, view: str = "standard") -> str:
    return os.path.join(root, "i", field, "views", view, "fragments",
                        str(shard))


def _write(root: str) -> None:
    """The reference writes the data: snapshots for every field, and two
    op-log records (left uncompacted) for ``g`` shard 2."""
    rng = np.random.default_rng(5)
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f").import_bits(
        rng.integers(0, 6, 6000).astype(np.uint64),
        rng.integers(0, N_SHARDS * SW, 6000).astype(np.uint64))
    mcols = np.unique(rng.integers(0, N_SHARDS * SW, 500)).astype(np.uint64)
    from pilosa_tpu.store import FieldOptions
    idx.create_field("m", FieldOptions(type="mutex")).import_bits(
        rng.integers(0, 3, len(mcols)).astype(np.uint64), mcols)
    ncols = np.unique(rng.integers(0, N_SHARDS * SW, 300)).astype(np.uint64)
    idx.create_field("n", FieldOptions(type="int", min=0, max=1000)) \
        .import_values(ncols, rng.integers(0, 1000, len(ncols)).tolist())
    from datetime import datetime
    idx.create_field("t", FieldOptions(type="time", time_quantum="YMD")) \
        .import_bits(np.array([1, 1, 2], np.uint64),
                     np.array([5, SW + 6, 9], np.uint64),
                     [datetime(2020, 1, 2), datetime(2020, 1, 5),
                      datetime(2020, 1, 2)])
    idx.create_field("g")
    h.close()
    h = JHolder(root).open()
    g = h.index("i").field("g")
    for rows in ([1, 1, 2], [2, 3, 1]):
        g.import_bits(np.array(rows, np.uint64),
                      np.array([2 * SW + 1, 2 * SW + 2, 2 * SW + 3],
                               np.uint64))
    # abandon without close: the op-log stays uncompacted
    h.snapshot_queue = None
    for i in h.indexes.values():
        for f in i.fields.values():
            for v in f.views.values():
                for fr in v.fragments.values():
                    fr._drop_snapshot()


def _flip(path: str, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def _oplog_second_record(path: str) -> int:
    """Offset of a byte inside the FIRST record's payload (the second
    record follows it: the corruption is mid-file)."""
    import struct
    crc, op, aux, plen = struct.unpack_from("<IBQI", open(path, "rb").read())
    assert os.path.getsize(path) > 17 + plen  # a second record follows
    return 17 + plen // 2


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("integrity") / "src")
    _write(root)
    return root


def _copies(written: str, tmp_path) -> tuple[str, str]:
    out = []
    for name in ("j", "t"):
        dst = str(tmp_path / name)
        shutil.copytree(written, dst)
        out.append(dst)
    return out[0], out[1]


def _damage(root: str) -> None:
    snap = _frag(root, "f", 1)
    _flip(snap, os.path.getsize(snap) - 7)
    log = _frag(root, "g", 2) + ".oplog"
    _flip(log, _oplog_second_record(log))


def _health(payload: dict, root: str) -> dict:
    out = {k: v for k, v in payload.items() if k != "sinceSeconds"}
    return json.loads(json.dumps(out).replace(root, "<root>"))


def _apis(jroot: str, troot: str, **kw):
    jh, th = JHolder(jroot).open(), THolder(troot).open()
    jex = JExecutor(jh, stats=JStats(), **kw)
    tex = TExecutor(th, device="cpu", stats=TStats(), **kw)
    return (JAPI(jh, jex, trace_sample_rate=0.0, slow_query_threshold=0.0),
            TAPI(th, tex, trace_sample_rate=0.0, slow_query_threshold=0.0))


def _q(api, pql: str, **kw) -> dict:
    """An answer without its trace id (the reference returns it in the
    dict, the port through ``last_trace_id``)."""
    out = api.query("i", pql, **kw)
    out.pop("traceId", None)
    return out


def _close(apis) -> None:
    for api in apis:
        close = getattr(api.executor, "close", None)
        if close is not None:
            close()
        api.holder.close()


def test_corrupt_snapshot_and_oplog_at_open(written, tmp_path):
    jroot, troot = _copies(written, tmp_path)
    for root in (jroot, troot):
        _damage(root)
    apis = _apis(jroot, troot, count_batch_window="off")
    japi, tapi = apis
    try:
        jh, th = japi.holder.storage_health, tapi.holder.storage_health
        assert _health(th.payload(), troot) == \
            _health(jh.payload(), jroot)
        q = th.quarantined_entries()
        assert [(e["kind"], e["key"]) for e in q] == \
            [("snapshot", ("i", "f", "standard", 1))]
        assert th.gate_active and th.shard_quarantined("i", 1)
        for pql in READS:
            assert _q(tapi, pql) == _q(japi, pql), pql
        # the quarantined fragment serves empty: shard 1 adds nothing
        f1 = [_q(tapi, f"Count(Row(f={r}))", shards=[1])
              for r in range(6)]
        assert all(a["results"] == [0] for a in f1)
        # the truncated op-log kept its clean prefix: none of g shard 2
        assert _q(tapi, "Count(Row(g=1))", shards=[2]) == \
            {"results": [0]}
    finally:
        _close(apis)


def _http(base: str, path: str, body: bytes | None = None):
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _servers(apis):
    srvs = [JServer(apis[0], "127.0.0.1", 0, stats=apis[0].executor.stats),
            TServer(apis[1], "127.0.0.1", 0)]
    for s in srvs:
        s.start()
    return srvs, [f"http://127.0.0.1:{s.address[1]}" for s in srvs]


def test_write_to_quarantined_fragment_503(written, tmp_path):
    jroot, troot = _copies(written, tmp_path)
    for root in (jroot, troot):
        _damage(root)
    apis = _apis(jroot, troot)
    srvs, bases = _servers(apis)
    try:
        got = []
        for base, root in zip(bases, (jroot, troot)):
            imp = _http(base, "/index/i/field/f/import",
                        json.dumps({"rowIDs": [1], "columnIDs": [SW + 5]})
                        .encode())
            pql = _http(base, "/index/i/query", f"Set({SW + 5}, f=1)"
                        .encode())
            ok = _http(base, "/index/i/field/f/import",
                       json.dumps({"rowIDs": [1], "columnIDs": [5]})
                       .encode())
            got.append(json.loads(json.dumps(
                [(r[0], r[1].get("Retry-After"), r[2])
                 for r in (imp, pql, ok)]).replace(root, "<root>")))
        assert got[1] == got[0]
        assert got[1][0][0] == 503 and got[1][0][2]["storageFault"] == {
            "path": "<root>/i/f/views/standard/fragments/1",
            "kind": "snapshot"}
        assert got[1][2][:1] == [200]
        status = _http(bases[1], "/status")[2]["storageHealth"]
        assert status["quarantined"][0]["key"] == {
            "index": "i", "field": "f", "view": "standard", "shard": 1}
    finally:
        for s in srvs:
            s.close()
        _close(apis)


def test_cli_check_bad_quarantined(written, tmp_path, capsys):
    jroot, troot = _copies(written, tmp_path)
    for root in (jroot, troot):
        _damage(root)
    assert tmain.main(["check", "--data-dir", troot]) == 1
    tout = capsys.readouterr().out
    assert jmain.main(["check", "--data-dir", jroot]) == 1
    jout = capsys.readouterr().out
    # the same lines (the views of a field may list in another order)
    assert sorted(tout.replace(troot, "<root>").splitlines()) == \
        sorted(jout.replace(jroot, "<root>").splitlines())
    assert f"BAD {_frag(troot, 'f', 1)}: quarantined (snapshot)" in tout
    assert tout.endswith("1 problems\n")


def test_disk_full_507_and_recovery(written, tmp_path):
    jroot, troot = _copies(written, tmp_path)
    apis = _apis(jroot, troot)
    srvs, bases = _servers(apis)
    try:
        got = []
        for api, base, mod in ((apis[0], bases[0], jhealth),
                               (apis[1], bases[1], thealth)):
            h = api.holder.storage_health
            h.configure(probe_seconds=60.0)  # the test probes by hand
            path = _frag(api.holder.path, "f", 0) + ".oplog"
            mod.note_os_error("oplog.append", path,
                              OSError(errno.ENOSPC, "No space left"),
                              health=h)
            body = json.dumps({"rowIDs": [1], "columnIDs": [7]}).encode()
            refused = _http(base, "/index/i/field/f/import", body)
            read = _http(base, "/index/i/query", b"Count(Row(f=1))")
            state = h.payload()
            recovered = h.probe_once()
            after = _http(base, "/index/i/field/f/import", body)
            got.append((refused[0], refused[1].get("Retry-After"),
                        refused[2], read[0], state["state"],
                        state["faults"], recovered, after[0],
                        h.payload()["state"]))
        assert got[1] == got[0]
        assert got[1][:3] == (507, "60", {
            "error": "node is read-only: disk full (writes refuse until "
                     "the space probe succeeds; reads keep serving)",
            "writeUnavailable": {"op": None, "replica": None,
                                 "reason": "disk_full"}})
        assert got[1][3:] == (200, "read_only", {"disk_full": 1}, True,
                              200, "healthy")
    finally:
        for s in srvs:
            s.close()
        _close(apis)


def test_eio_streak_quarantines_one_fragment():
    out = []
    for mod in (jhealth, thealth):
        h = mod.StorageHealth(base="/d")
        p = "/d/i/f/views/standard/fragments/3.oplog"
        err = OSError(errno.EIO, "I/O error")
        kinds = [h.note_fault(p, err) for _ in range(2)]
        h.note_write_success(p)  # the streak is consecutive failures
        kinds += [h.note_fault(p, err) for _ in range(3)]
        with pytest.raises(mod.StorageFaultError) as ei:
            h.check_write(p[:-len(".oplog")])
        out.append((kinds, h.state, str(ei.value), ei.value.kind,
                    [(e["kind"], e["key"], e["detail"])
                     for e in h.quarantined_entries()],
                    mod.classify_oserror(OSError(errno.EROFS, "ro")),
                    mod.frag_path_of("/x/1.dense")))
        h.close()
    assert out[1] == out[0]


def _scrub_pair(written, tmp_path, **kw):
    jroot, troot = _copies(written, tmp_path)
    apis = _apis(jroot, troot, count_batch_window="off")
    for api in apis:  # as the server wires it
        api.holder.storage_health.configure(stats=api.executor.stats)
    scrubs = [S(api.holder, interval=600.0, stats=api.executor.stats, **kw)
              for S, api in zip((JScrubber, TScrubber), apis)]
    return apis, scrubs


def test_scrubber_quarantines_live_corruption(written, tmp_path):
    apis, scrubs = _scrub_pair(written, tmp_path, bytes_per_second=1 << 40)
    japi, tapi = apis
    try:
        want = [_q(tapi, f"Count(Row(f={r}))") for r in range(6)]
        assert want == [_q(japi, f"Count(Row(f={r}))") for r in range(6)]
        shard1 = [_q(tapi, f"Count(Row(f={r}))", shards=[1])["results"][0]
                  for r in range(6)]
        # a sidecar for f shard 0, written by the port, then damaged
        th = tapi.holder
        frag0 = th.index("i").field("f").view("standard").fragment(0)
        ids = np.array(sorted(frag0.row_ids()), np.uint64)
        frag0.expand_rows_into(ids, np.zeros((len(ids), SW // 32),
                                             np.uint32), sidecar=True)
        assert os.path.exists(frag0.dense_path)
        shutil.copy(frag0.dense_path, _frag(japi.holder.path, "f", 0)
                    + ".dense")
        for api in apis:
            root = api.holder.path
            snap = _frag(root, "f", 1)
            _flip(snap, os.path.getsize(snap) - 7)  # under the live map
            log = _frag(root, "g", 2) + ".oplog"
            _flip(log, _oplog_second_record(log))
            _flip(_frag(root, "f", 0) + ".dense", 60)
        passes = [s.run_once() for s in scrubs]
        for p in passes:
            p.pop("seconds")
        assert passes[1] == passes[0]
        assert passes[1]["corrupt"] == 3
        assert not os.path.exists(frag0.dense_path)
        assert _health(th.storage_health.payload(), th.path) == \
            _health(japi.holder.storage_health.payload(), japi.holder.path)
        assert sorted(e["kind"] for e in
                      th.storage_health.quarantined_entries()) == \
            ["oplog", "snapshot"]
        # the poisoned fragment serves its op-log alone (none): shard 1's
        # rows drop out of the answers, as in the reference
        got = [_q(tapi, f"Count(Row(f={r}))") for r in range(6)]
        assert got == [_q(japi, f"Count(Row(f={r}))") for r in range(6)]
        assert [g["results"][0] for g in got] == \
            [w["results"][0] - s for w, s in zip(want, shard1)]
        text = tapi.executor.stats.prometheus_text()
        for kind in ("snapshot", "oplog", "sidecar"):
            assert (f'storage_corruption_detected_total{{kind="{kind}"}} '
                    "1") in text
        assert "storage_scrub_bytes_total" in text
        # a quarantined fragment refuses writes and is not compacted
        frag1 = th.index("i").field("f").view("standard").fragment(1)
        with pytest.raises(thealth.StorageFaultError):
            frag1.set_bits(np.array([1], np.uint64),
                           np.array([3], np.uint64))
        before = open(frag1.path, "rb").read()
        frag1.snapshot()
        assert open(frag1.path, "rb").read() == before
        # a second pass skips the quarantined fragments
        again = [s.run_once()["corrupt"] for s in scrubs]
        assert again == [0, 0]
    finally:
        _close(apis)


def test_scrubber_bytes_budget(written, tmp_path):
    total = 0
    for dirpath, _, files in os.walk(written):
        if "fragments" in dirpath:
            total += sum(os.path.getsize(os.path.join(dirpath, f))
                         for f in files)
    rate = int(total / 0.6)  # a pass of about 0.6 s
    apis, scrubs = _scrub_pair(written, tmp_path, bytes_per_second=rate)
    try:
        t0 = time.monotonic()
        tpass = scrubs[1].run_once()
        wall = time.monotonic() - t0
        jpass = scrubs[0].run_once()
        assert tpass["bytes"] == jpass["bytes"] == total
        assert tpass["files"] == jpass["files"]
        assert tpass["corrupt"] == 0
        # paced: the last chunk may land before its sleep, so the floor
        # is one chunk short of the budget
        assert wall >= (total - (4 << 20)) / rate - 0.05
        pay = scrubs[1].payload()
        assert (pay["enabled"], pay["passes"], pay["bytesScanned"],
                pay["bytesPerSecond"]) == (True, 1, total, rate)
        assert TScrubber(apis[1].holder, bytes_per_second=0).start() \
            ._thread is None  # 0 bytes/s: no thread
    finally:
        _close(apis)
