"""The port's concurrent serving spine: the cross-request ``CountBatcher``,
the plan cache and the launch counters, on the CPU.

Concurrent clients over one executor must give the answers of the same
requests made one at a time (which ``test_torch_slice.py`` holds against
the JAX package); the batcher must coalesce (fewer whole-plane scans than
requests), deliver a failing launch to every caller that waited on it
and keep serving, and fall back nowhere; the plan cache must hit on a
repeat and see a write.  Threads are joined with a timeout and checked
for liveness, so a lost wake-up fails instead of hanging the suite.
"""

import gc
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.engine import cuda_kernels
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.batcher import CountBatcher, _Pending
from pilosa_tpu_torch.exec.executor import parse_window
from pilosa_tpu_torch.exec.fused import FusedCache
from pilosa_tpu_torch.store import Holder
from test_torch_slice import COUNTS, READS, _port_api, _write_index
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

QT = ("Count(Intersect(Row(f=1), Union(Row(f=2), Row(f=5)), Row(g=0)))"
      "Count(Difference(Union(Row(f=1), Row(f=2)), Row(f=3)))"
      "Count(Xor(Row(f=4), Row(f=7)))")
MIX = [COUNTS, READS[1], READS[4], READS[5], "TopN(f, Row(g=0), n=5)", QT,
       "Count(Row(f=5))", "Count(Not(Row(f=1)))"]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("batcher") / "data")
    _write_index(root)
    return root


@pytest.fixture(scope="module")
def sequential(index_dir):
    """Every MIX answer, one request at a time through the port in the
    "off" configuration."""
    holder, api = _port_api(index_dir, "off")
    try:
        return {q: api.query("i", q) for q in MIX}
    finally:
        holder.close()


def _run_threads(target, n: int, timeout: float = 120.0) -> None:
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=target, args=(k,), daemon=True)
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("window", ["adaptive", "0.01"])
def test_concurrent_mix_equals_sequential(index_dir, sequential, window):
    holder = Holder(index_dir).open()
    api = API(holder, Executor(holder, device="cpu",
                               count_batch_window=window))
    errors = []

    def client(k):
        try:
            for j in range(3):
                q = MIX[(k + j) % len(MIX)]
                got = api.query("i", q)
                if got != sequential[q]:
                    errors.append((q, got, sequential[q]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        _run_threads(client, 16)
        stats = api.executor.serving_stats()
    finally:
        api.executor.close()
        holder.close()
    assert not errors, errors[:3]
    assert stats["windows"] >= 1 and stats["items"] >= stats["windows"]


def _barrier_clients(ex, pql: str, n: int):
    """``n`` threads released together, each executing ``pql`` once;
    returns [(result or exception)] in thread order."""
    out: list = [None] * n
    start = threading.Barrier(n, timeout=60)

    def client(k):
        start.wait()
        try:
            out[k] = ex.execute("i", pql)
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[k] = e

    _run_threads(client, n)
    return out


def test_window_coalesces_row_counts(index_dir, sequential, monkeypatch):
    """With a fixed 50 ms window, 8 concurrent 32-Counts over one
    resident plane make fewer whole-plane scans than requests."""
    holder = Holder(index_dir).open()
    ex = Executor(holder, device="cpu", count_batch_window=0.05)
    calls = []
    real = tk.row_counts
    monkeypatch.setattr(tk, "row_counts",
                        lambda *a: (calls.append(1), real(*a))[1])
    try:
        want = sequential[COUNTS]["results"]
        assert ex.execute("i", COUNTS) == want    # plane resident, planned
        calls.clear()
        got = _barrier_clients(ex, COUNTS, 8)
        stats = ex.serving_stats()
    finally:
        ex.close()
        holder.close()
    assert all(g == want for g in got)
    assert 1 <= len(calls) < 8
    assert stats["maxWindowItems"] > 1


def test_failing_launch_reaches_every_caller(index_dir, sequential):
    """A group whose launch raises delivers that exception to each of its
    callers, and the next window is served."""
    holder = Holder(index_dir).open()
    ex = Executor(holder, device="cpu", count_batch_window=0.05)
    real = ex.fused.run_rowcounts_batch
    failing = threading.Event()
    failing.set()

    def flaky(*a, **k):
        if failing.is_set():
            raise RuntimeError("launch refused")
        return real(*a, **k)

    ex.fused.run_rowcounts_batch = flaky
    try:
        want = sequential[COUNTS]["results"]
        got = _barrier_clients(ex, COUNTS, 4)
        assert all(isinstance(g, RuntimeError) and "launch refused"
                   in str(g) for g in got), got
        failing.clear()
        assert ex.execute("i", COUNTS) == want
        assert ex.batcher._thread.is_alive()
    finally:
        ex.close()
        holder.close()


def test_failing_fastlane_raises_without_fallback(index_dir, sequential):
    """A solo request's fast-lane launch that raises reaches its caller:
    the window does not retry it."""
    holder = Holder(index_dir).open()
    ex = Executor(holder, device="cpu")
    calls = []

    def refuse(*a, **k):
        calls.append(1)
        raise RuntimeError("launch refused")

    try:
        assert ex.execute("i", READS[1]) == sequential[READS[1]]["results"]
        windows = ex.batcher.windows
        ex.fused.run_selected_counts = refuse
        with pytest.raises(RuntimeError, match="launch refused"):
            ex.execute("i", READS[1])
        assert len(calls) == 1 and ex.batcher.windows == windows
    finally:
        ex.close()
        holder.close()


def test_plan_cache_hits_and_sees_writes(tmp_path):
    root = str(tmp_path)
    _write_index(root)
    holder = Holder(root).open()
    ex = Executor(holder, device="cpu")
    try:
        for q in (COUNTS, QT):
            first = ex.execute("i", q)
            hits = ex.plan_hits
            assert ex.execute("i", q) == first
            assert ex.plan_hits == hits + 1
        # a write between two identical queries changes the answer; the
        # plan survives it (nothing in it is stale)
        col = 2 * (1 << 20) + 12345
        f7 = ex.execute("i", "Count(Row(f=7))")[0]
        ex.execute("i", "Count(Row(f=7))")
        ex.execute("i", f"Set({col}, f=7)")
        hits = ex.plan_hits
        assert ex.execute("i", "Count(Row(f=7))") == [f7 + 1]
        assert ex.plan_hits == hits + 1
        q = "Count(Intersect(Row(f=7), Row(f=7)))"
        assert ex.execute("i", q) == [f7 + 1]
        ex.execute("i", f"Clear({col}, f=7)")
        assert ex.execute("i", q) == [f7]
        # a query over another shard set is another plan
        assert ex.execute("i", COUNTS, shards=[0]) != ex.execute(
            "i", COUNTS)
        ex.invalidate_plans("i")
        misses = ex.plan_misses
        ex.execute("i", COUNTS)
        assert ex.plan_misses == misses + 1
    finally:
        ex.close()
        holder.close()


def test_saturated_executor_answers_503(index_dir):
    """A query that finds every admission slot taken past the slot
    timeout is refused (HTTP 503 at the API), and the slot it never got
    is not released."""
    from pilosa_tpu_torch.api import ApiError
    holder = Holder(index_dir).open()
    api = API(holder, Executor(holder, device="cpu", max_concurrent=1))
    ex = api.executor
    ex.SLOT_TIMEOUT_S = 0.05
    try:
        assert ex._exec_slots.acquire(timeout=5)   # the only slot
        with pytest.raises(ApiError) as e:
            api.query("i", "Count(Row(f=1))")
        assert e.value.status == 503
        ex._exec_slots.release()
        assert api.query("i", "Count(Row(f=1))")["results"][0] > 0
        with pytest.raises(ValueError):   # free again: no extra release
            ex._exec_slots.release()
    finally:
        ex.close()
        holder.close()


def test_off_configuration_has_no_batcher(index_dir, sequential):
    holder, api = _port_api(index_dir, "off")
    try:
        assert api.executor.batcher is None
        assert not api.executor.tree_fusion
        assert api.query("i", QT) == sequential[QT]
        assert api.status()["batcher"]["window"] == "off"
    finally:
        holder.close()


def test_status_batcher_block(index_dir):
    holder, api = _port_api(index_dir)
    try:
        api.query("i", COUNTS)
        api.query("i", COUNTS)
        block = api.status()["batcher"]
        assert block["window"] == "adaptive"
        assert block["fastLaneHits"] >= 1
        assert block["planCacheHits"] >= 1 and block["planCacheMisses"] >= 1
        for key in ("windows", "items", "currentWindowSeconds"):
            assert key in block
    finally:
        api.executor.close()
        holder.close()


@pytest.mark.parametrize("given,want", [
    ("adaptive", "adaptive"), (" Adaptive ", "adaptive"), ("off", 0.0),
    ("0", 0.0), ("", 0.0), ("0.05", 0.05), (0.002, 0.002), (0, 0.0)])
def test_parse_window(given, want):
    assert parse_window(given) == want


def test_parse_window_refuses_junk():
    with pytest.raises(ValueError):
        parse_window("soon")


def test_launch_counters_lose_nothing():
    """8 threads x 1000 counts under a short switch interval: every count
    lands."""
    before = dict(cuda_kernels.LAUNCHES)
    cuda_kernels.reset_launches()
    try:
        def bump(_k):
            for _ in range(1000):
                cuda_kernels._count("count")

        _run_threads(bump, 8)
        assert cuda_kernels.LAUNCHES["count"] == 8000
    finally:
        cuda_kernels.reset_launches()
        for k, v in before.items():
            cuda_kernels.LAUNCHES[k] = v


def test_batcher_close_fails_queued_items():
    """Items still queued when the batcher closes fail instead of
    waiting forever; a submit after close raises."""
    b = CountBatcher(FusedCache(), window_s=0.05)
    p = _Pending("rowcounts", None, (np.zeros(1),))
    b._queue.append(p)
    b.close()
    assert p.event.is_set() and isinstance(p.error, RuntimeError)
    with pytest.raises(RuntimeError):
        b.enqueue_rowcounts(np.zeros(1))


def test_finished_window_releases_its_operands():
    """Once a window's answers are delivered the batcher holds none of
    its operands: a plane replaced by a fold or a rebuild is freed, not
    kept alive by the last window the reader saw."""
    b = CountBatcher(FusedCache(), window_s=0.01)
    try:
        plane = torch.ones((2, 4, 8), dtype=torch.int32)
        ref = weakref.ref(plane)
        assert b.submit_rowcounts(plane).tolist() == [16] * 4
        del plane
        deadline = time.monotonic() + 10
        while ref() is not None and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.01)
        assert ref() is None
    finally:
        b.close()
