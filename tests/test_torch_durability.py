"""Durable batched writes and background compaction in the port, against
``pilosa_tpu.store``: ``SyncBatch`` (one ``os.fsync`` per touched log),
op-log and snapshot bytes after the same imports with ``fsync=True``, the
``SnapshotQueue`` (dedupe, drain, close), a holder opened on a pool equal
to one opened index by index, the ``/status`` storage block, and the
write path's changed counts, journals and op-log bytes over random set
and clear interleavings that cross ``PEND_FLUSH_N``."""

import os
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store.fragment import Fragment as JFragment
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import oplog as toplog
from pilosa_tpu_torch.store.fragment import Fragment as TFragment
from pilosa_tpu_torch.store.holder import SnapshotQueue
from pilosa_tpu_torch.store.oplog import OpLog, SyncBatch
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20


@pytest.fixture
def fsyncs(monkeypatch):
    """Every ``os.fsync`` the port's op-logs issue, by path."""
    seen: list[str] = []
    real = os.fsync

    def counted(fd):
        seen.append(os.readlink(f"/proc/self/fd/{fd}"))
        return real(fd)

    monkeypatch.setattr(toplog.os, "fsync", counted)
    return seen


def _tree(root: str, suffixes=(".oplog",)) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if f.endswith(suffixes) or (suffixes == ("",) and f.isdigit()):
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


def _sizes(root: str) -> dict:
    """Op-log sizes by path."""
    return {os.path.join(d, f): os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".oplog")}


def _records(root: str) -> int:
    """Op-log records under ``root``."""
    return sum(1 for d, _, files in os.walk(root) for f in files
               if f.endswith(".oplog")
               for _ in OpLog(os.path.join(d, f)).replay())


def _snapshots(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.isdigit():
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


# -- SyncBatch ----------------------------------------------------------------


def test_syncbatch_one_fsync_per_touched_log(tmp_path, fsyncs):
    logs = [OpLog(str(tmp_path / f"{i}.oplog"), fsync=True)
            for i in range(3)]
    sb = SyncBatch()
    for rep in range(4):
        for log in logs[:2]:
            log.append(1, 0, np.array([rep, rep + 7], np.uint64),
                       sync_batch=sb)
    assert fsyncs == []                       # deferred to the flush
    assert sb.flush() == 2
    assert sorted(fsyncs) == sorted(log.path for log in logs[:2])
    assert sb.flush() == 0                    # a flushed batch is empty
    logs[2].append(1, 0, np.array([1], np.uint64))
    assert fsyncs[-1] == logs[2].path         # no batch: synced inline
    # fsync off: the batch notes nothing
    quiet = OpLog(str(tmp_path / "q.oplog"))
    quiet.append(1, 0, np.array([1], np.uint64), sync_batch=sb)
    assert sb.flush() == 0 and quiet.size() > 0
    assert OpLog(str(tmp_path / "absent.oplog")).size() == 0


def test_syncbatch_failed_append_truncates_torn_tail(tmp_path, monkeypatch):
    """A short write with the fsync deferred still cuts the log back to
    its whole-record prefix, and the batch's flush still works."""
    log = OpLog(str(tmp_path / "a.oplog"), fsync=True)
    sb = SyncBatch()
    log.append(1, 0, np.array([1, 2], np.uint64), sync_batch=sb)
    clean = log.size()
    real_open = open

    class Short:
        def __init__(self, f):
            self.f = f

        def write(self, b):
            self.f.write(b[:5])
            raise OSError(28, "No space left on device")

        def __getattr__(self, name):
            return getattr(self.f, name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.f.close()

    def opener(path, mode="r", *a, **k):
        f = real_open(path, mode, *a, **k)
        return Short(f) if mode == "ab" else f

    monkeypatch.setattr("builtins.open", opener)
    with pytest.raises(OSError):
        log.append(1, 0, np.array([3], np.uint64), sync_batch=sb)
    monkeypatch.undo()
    assert log.size() == clean
    assert sb.flush() == 1
    assert [p.tolist() for _, _, p in log.replay()] == [[1, 2]]


def _apis(tmp_path, fsync=True):
    jh = JHolder(str(tmp_path / "j"), fsync=fsync).open()
    th = THolder(str(tmp_path / "t"), fsync=fsync).open()
    japi = JAPI(jh, JExecutor(jh, kernel_tier="pallas"))
    tapi = TAPI(th, TExecutor(th, device="cpu"))
    for api in (japi, tapi):
        api.create_index("i")
        api.create_field("i", "f")
        api.create_field("i", "m", {"type": "mutex"})
    return (jh, japi), (th, tapi)


def _close(pair) -> None:
    (jh, japi), (th, tapi) = pair
    japi.executor.translate.close()
    tapi.executor.close()
    jh.close()
    th.close()


def test_rest_imports_durable_and_byte_equal(tmp_path, monkeypatch, fsyncs):
    """The same imports through both APIs with ``fsync=True``: equal
    changed counts, op-log bytes, and (after the close compacts) snapshot
    bytes; each import's flush fsyncs every log it touched once."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    pair = _apis(tmp_path)
    (jh, japi), (th, tapi) = pair
    rng = np.random.default_rng(4)
    mine = fsyncs  # os.fsync is one function: keep the port's own paths

    def port(since):
        return [p for p in mine[since:] if p.startswith(th.path + os.sep)]

    try:
        for step in range(6):
            rows = rng.integers(0, 6, 3000).tolist()
            cols = rng.integers(0, 3 * SW, 3000).tolist()
            clear = step == 4
            before, sizes = len(fsyncs), _sizes(th.path)
            got = [api.import_bits("i", "f", row_ids=rows, col_ids=cols,
                                   clear=clear) for api in (japi, tapi)]
            assert got[0] == got[1]
            grown = {p for p, n in _sizes(th.path).items()
                     if n != sizes.get(p, 0)}
            assert grown and sorted(port(before)) == sorted(grown)
            assert tapi.last_import_fsyncs == len(grown)
        # mutex batches: several records per touched log, one fsync
        mrows = rng.integers(0, 5, 2000).tolist()
        mcols = rng.integers(0, 2 * SW, 2000).tolist()
        for i in range(3):
            before, sizes = len(fsyncs), _sizes(th.path)
            records = _records(th.path)
            got = [api.import_bits("i", "m", row_ids=mrows, col_ids=mcols)
                   for api in (japi, tapi)]
            assert got[0] == got[1]
            grown = {p for p, n in _sizes(th.path).items()
                     if n != sizes.get(p, 0)}
            assert sorted(port(before)) == sorted(grown)
            if i:  # the rows exist: each batch clears them, then sets
                assert _records(th.path) - records > 2 * len(grown)
            mrows = rng.permutation(mrows).tolist()
        # import-roaring: one fsync per log too
        from pilosa_tpu.store import roaring as jroaring
        blob = jroaring.serialize(np.array([SW * 2 + 5, 9], np.uint64))
        before = len(fsyncs)
        assert japi.import_roaring("i", "f", 1, blob) \
            == tapi.import_roaring("i", "f", 1, blob)
        assert len(port(before)) == 2  # f's shard 1 and _exists
        assert _tree(th.path) == _tree(jh.path)
        st = tapi.status()["storage"]
        assert st["fsync"] is True and st["importFsyncs"] > 0
        jst = japi.storage_stats()
        assert {k: st[k] for k in jst} == jst
    finally:
        _close(pair)
    assert _snapshots(th.path) == _snapshots(jh.path)


# -- background compaction ---------------------------------------------------


class _Frag:
    def __init__(self, gate=None):
        self.path = "frag"
        self.op_n = 5
        self.calls = 0
        self.gate = gate

    def maybe_snapshot(self):
        if self.gate is not None:
            self.gate.wait(30)
        self.calls += 1
        self.op_n = 0


def test_snapshot_queue_dedupes_and_drains():
    q = SnapshotQueue()
    gate = threading.Event()
    busy, a, b = _Frag(gate), _Frag(), _Frag()
    q.submit(busy)                 # the worker blocks on it
    for _ in range(3):
        q.submit(a)                # deduped while queued
    q.submit(b)
    assert q.pending() == 3
    gate.set()
    assert q.wait_idle(30)
    assert (busy.calls, a.calls, b.calls) == (1, 1, 1)
    assert q.compactions == 3 and q.pending() == 0
    q.close()
    late = _Frag()
    q.submit(late)                 # closed: compacted inline
    assert late.calls == 1


def test_snapshot_queue_close_compacts_leftovers():
    q = SnapshotQueue()
    frags = [_Frag() for _ in range(3)]
    with q._cv:                    # queued with no worker started
        q._pending.extend(frags)
        q._inq.update(id(f) for f in frags)
    q.close()
    assert [f.calls for f in frags] == [1, 1, 1]


def _compacted(frag, timeout: float = 60.0) -> None:
    """Wait until a fragment handed to a background queue is back under
    its ``max_op_n``: each package's queue then compacted the same state."""
    deadline = time.monotonic() + timeout
    while frag.op_n > frag.max_op_n:
        assert time.monotonic() < deadline, "the compaction never ran"
        time.sleep(0.005)


def test_background_compaction_off_the_write_path(tmp_path):
    """Past ``max_op_n`` records the write hands the fragment to the queue
    and returns; the compaction leaves the reference's snapshot bytes and
    an empty log.  Each batch waits for the handed-over compaction in both
    packages, so both compact after the same record."""
    frags = []
    for pkg, H in (("j", JHolder), ("t", THolder)):
        h = H(str(tmp_path / pkg)).open()
        f = h.create_index("i").create_field("f")
        frag = f.standard_view(create=True).fragment(0, create=True)
        frag.max_op_n = 20
        frags.append((h, f, frag))
    rng = np.random.default_rng(6)
    for _ in range(25):
        rows = rng.integers(0, 4, 40).astype(np.uint64)
        cols = rng.integers(0, SW, 40).astype(np.uint64)
        got = [f.import_bits(rows, cols) for _, f, _ in frags]
        assert got[0] == got[1]
        for _, _, frag in frags:
            _compacted(frag)
    (jh, _, jfrag), (th, _, tfrag) = frags
    assert th.snapshot_queue.wait_idle(60)
    jh._snap_queue.close()
    assert th.snapshot_queue.compactions >= 1
    assert tfrag.op_n == jfrag.op_n <= 20
    with open(tfrag.path, "rb") as a, open(jfrag.path, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tfrag.positions(), jfrag.positions())
    jh.close()
    th.close()


def test_sync_holder_compacts_inline(tmp_path):
    h = THolder(str(tmp_path), async_snapshots=False).open()
    assert h.snapshot_queue is None
    frag = h.create_index("i").create_field("f").standard_view(
        create=True).fragment(0, create=True)
    frag.max_op_n = 3
    for c in range(5):
        frag.set_bits(np.array([1], np.uint64), np.array([c], np.uint64))
    assert frag.op_n == 1 and os.path.getsize(frag.path) > 0
    h.close()


# -- holder open --------------------------------------------------------------


def test_concurrent_open_equals_sequential(tmp_path):
    root = str(tmp_path / "d")
    h = THolder(root).open()
    rng = np.random.default_rng(8)
    for i in range(6):
        f = h.create_index(f"x{i}").create_field("f")
        f.import_bits(rng.integers(0, 5, 3000).astype(np.uint64),
                      rng.integers(0, 3 * SW, 3000).astype(np.uint64))
    h.close()
    # some op-logs left to replay
    h = THolder(root).open()
    h.index("x2").field("f").import_bits(np.array([9], np.uint64),
                                         np.array([77], np.uint64))
    del h  # not closed: a killed process

    def state(holder):
        return {(i, v, s): frag.positions().tolist()
                for i, idx in holder.indexes.items()
                for fname, f in idx.fields.items()
                for v, view in f.views.items()
                for s, frag in view.fragments.items()}

    pooled = THolder(root).open()
    seq = THolder(root)
    seq.OPEN_WORKERS = 1
    seq.open()
    assert sorted(pooled.indexes) == [f"x{i}" for i in range(6)]
    assert state(pooled) == state(seq)
    jh = JHolder(root).open()
    assert state(pooled) == state(jh)
    jh._snap_queue.close()


# -- the write path against the reference's pending tier ---------------------


def _journal(frag, gen):
    got = frag.changed_cells_since(gen)
    if got is None:
        return None
    return {int(r): (None if w is None else sorted(int(x) for x in w))
            for r, w in got.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writes_equal_reference_across_pend_flush(tmp_path, seed):
    """Random set and clear batches, some past ``PEND_FLUSH_N``, on a
    snapshot-backed fragment: every changed count, generation and journal
    equals the reference's (whose small set batches go through its
    pending tier), and so do the op-log and, after a compaction, the
    snapshot bytes."""
    rng = np.random.default_rng(seed)
    jf = JFragment(str(tmp_path / "j" / "0"), 0).open()
    tf = TFragment(str(tmp_path / "t" / "0"), 0).open()
    base_rows = rng.integers(0, 8, 50000).astype(np.uint64)
    base_cols = rng.integers(0, SW, 50000).astype(np.uint64)
    for f in (jf, tf):
        os.makedirs(os.path.dirname(f.path), exist_ok=True)
        f.set_bits(base_rows, base_cols)
        f.snapshot()
    assert tf.PEND_FLUSH_N == jf.PEND_FLUSH_N
    sizes = [10, 3000, 70000, 200, 65536, 65535, 1, 40000, 90000, 5]
    for step, n in enumerate(sizes * 2):
        rows = rng.integers(0, 10, n).astype(np.uint64)
        cols = rng.integers(0, SW, n).astype(np.uint64)
        if step % 4 == 3:
            # clears hit bits that are set
            pos = tf.positions()
            pick = pos[rng.integers(0, len(pos), n)]
            rows, cols = pick // np.uint64(SW), pick % np.uint64(SW)
            op = "clear_bits"
        else:
            op = "set_bits"
        gens = (jf.generation, tf.generation)
        got = [getattr(f, op)(rows, cols) for f in (jf, tf)]
        assert got[0] == got[1], (step, op, n)
        assert jf.generation - gens[0] == tf.generation - gens[1]
        assert _journal(jf, gens[0]) == _journal(tf, gens[1]), (step, n)
        assert jf.cardinality() == tf.cardinality()
    np.testing.assert_array_equal(jf.positions(), tf.positions())
    with open(jf._oplog.path, "rb") as a, open(tf._oplog.path, "rb") as b:
        assert a.read() == b.read()
    for f in (jf, tf):
        f.snapshot()
    with open(jf.path, "rb") as a, open(tf.path, "rb") as b:
        assert a.read() == b.read()

