"""The port's robustness slice against ``pilosa_tpu`` on the CPU: query
deadlines through the batcher, the watchdog and window quarantine, the
device-health governor, device-OOM recovery, the ``distinct`` batcher
kind, and the API's 504 / 500 bodies.

The classes mirror the reference's ``tests/test_pipeline_resilience.py``
(``TestDeadlinePropagation``, ``TestWatchdogQuarantine``,
``TestGovernor``, ``TestKnobOffContract``), each run against the port's
executor with the port's fault registry; where a test compares, the
reference runs the same schedule through its own registry.  Hangs are
short and every thread is joined with a timeout.

One difference is pinned on purpose: a window launch that raises reaches
every caller of its group (the reference retries it item by item), and
still counts a governor fault.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu import fault as jfault
from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import ApiError as JApiError
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.batcher import CountBatcher as JBatcher
from pilosa_tpu.exec.batcher import _Pending as JPending
from pilosa_tpu.exec.executor import PipelineStalledError as JStall
from pilosa_tpu.exec.executor import QueryTimeoutError as JTimeout
from pilosa_tpu.exec.health import DeviceHealthGovernor as JGovernor
from pilosa_tpu.obs import Stats
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import ApiError as TApiError
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec.batcher import CountBatcher as TBatcher
from pilosa_tpu_torch.exec.batcher import _Pending as TPending
from pilosa_tpu_torch.exec.errors import PipelineStalledError as TStall
from pilosa_tpu_torch.exec.errors import QueryTimeoutError as TTimeout
from pilosa_tpu_torch.exec.executor import _is_device_oom
from pilosa_tpu_torch.exec.health import DeviceHealthGovernor as TGovernor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
WORDS = SW // 32
N_SHARDS, N_ROWS = 2, 16


@pytest.fixture(autouse=True)
def _clean_faults():
    jfault.clear()
    tfault.clear()
    yield
    jfault.clear()
    tfault.clear()


def _write_plane(root: str) -> np.ndarray:
    """Index ``i``, field ``f``: 2 shards x 16 rows of ~25% dense words as
    snapshots (the reference test's recipe); returns the per-row oracle."""
    rng = np.random.default_rng(23)
    plane = rng.integers(0, 1 << 32, size=(N_SHARDS, N_ROWS, WORDS),
                         dtype=np.uint32)
    plane &= rng.integers(0, 1 << 32, size=plane.shape, dtype=np.uint32)
    h = JHolder(root).open()
    h.create_index("i", track_existence=False).create_field("f")
    h.close()
    d = os.path.join(root, "i", "f", "views", "standard", "fragments")
    os.makedirs(d, exist_ok=True)
    for s in range(N_SHARDS):
        with open(os.path.join(d, str(s)), "wb") as fh:
            fh.write(jroaring.serialize_dense(plane[s]))
    return np.bitwise_count(plane).sum(axis=(0, 2), dtype=np.int64)


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("robust") / "data")
    oracle = _write_plane(root)
    return root, oracle


@pytest.fixture
def served(index_dir, tmp_path):
    """A port holder over a copy of the index, and the row oracle."""
    root = str(tmp_path / "t")
    shutil.copytree(index_dir[0], root)
    holder = THolder(root).open()
    yield holder, index_dir[1]
    holder.close()


@pytest.fixture
def jserved(index_dir, tmp_path):
    root = str(tmp_path / "j")
    shutil.copytree(index_dir[0], root)
    holder = JHolder(root).open()
    yield holder, index_dir[1]
    holder.close()


def _ex(holder, **kw) -> TExecutor:
    return TExecutor(holder, device="cpu", **kw)


def _resident(ex, holder):
    idx = holder.index("i")
    return ex.planes.field_plane("i", idx.field("f"), "standard",
                                 tuple(idx.available_shards()))


def _census() -> dict:
    names = [t.name for t in threading.enumerate()]
    return {n: sum(1 for x in names if x.startswith(n))
            for n in ("pilosa-torch-batcher", "pilosa-torch-readback",
                      "pilosa-torch-watchdog")}


def _await_census(baseline: dict, timeout: float = 20.0) -> dict:
    end = time.monotonic() + timeout
    census = {}
    while time.monotonic() < end:
        census = _census()
        if all(census[k] <= baseline[k] for k in baseline):
            break
        time.sleep(0.1)
    return census


def _tighten(batcher, bound: float) -> None:
    """Shrink the watchdog's bound live, then outwait the monitor's last
    tick at the old bound (at most 1 s)."""
    batcher.watchdog_s = bound
    time.sleep(1.05)


def _serve_until_healthy(ex, oracle, row: int, timeout: float = 15.0):
    """Serve exact Counts until a probe restores healthy, under a bound no
    loaded CPU's launch outlives (the stalled window is already
    quarantined)."""
    ex.batcher.watchdog_s = 5.0
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        assert ex.execute("i", f"Count(Row(f={row}))") == [int(oracle[row])]
        if ex.batcher.governor.state == "healthy":
            return
        time.sleep(0.02)
    raise AssertionError(f"governor stuck {ex.batcher.governor.state}")


class TestDeadlinePropagation:
    def test_expired_deadline_refused_before_dispatch(self, served,
                                                      jserved):
        """An expired deadline never takes a window slot: it fails up
        front, naming the stage, in both packages."""
        holder, _ = served
        ex = _ex(holder)
        jex = JExecutor(jserved[0], stats=Stats())
        try:
            stages = []
            for e, exc in ((ex, TTimeout), (jex, JTimeout)):
                ps = _resident(e, holder if e is ex else jserved[0])
                with pytest.raises(exc) as ei:
                    e.batcher.submit_rowcounts(
                        ps.plane, deadline=time.monotonic() - 1.0)
                with pytest.raises(exc) as ej:
                    e.batcher.enqueue_rowcounts(
                        ps.plane, deadline=time.monotonic() - 1.0)
                stages.append((ei.value.stage, ej.value.stage))
            assert stages[0] == stages[1] == ("dispatch", "queued")
        finally:
            ex.close()

    @pytest.mark.parametrize("pkg", ["port", "reference"])
    def test_wait_deadline_boundary_never_returns_none(self, pkg):
        """A late deliverer that saw the abandon mark stores nothing: the
        wait raises, never returns None; a store that landed first is an
        answer."""
        pending, batcher, exc = ((TPending, TBatcher, TTimeout)
                                 if pkg == "port"
                                 else (JPending, JBatcher, JTimeout))
        p = pending("count", None, (None,),
                    deadline=time.monotonic() - 0.01)
        p.abandoned = True
        batcher._deliver(p, [42])
        assert p.event.is_set() and p.result is None
        with pytest.raises(exc):
            batcher.wait(None, p)
        q = pending("count", None, (None,),
                    deadline=time.monotonic() - 0.01)
        batcher._deliver(q, [42])
        assert batcher.wait(None, q) == [42]

    def test_deadline_expiry_mid_window_leaves_cobatched_exact(
            self, served, jserved):
        """One caller's expiry mid-window leaves its co-batched neighbour
        exact; the expired caller's error names the same stage in both
        packages."""
        stages = {}
        for pkg in ("port", "reference"):
            if pkg == "port":
                holder, oracle = served
                ex = _ex(holder, count_batch_window=0.005,
                         solo_fastlane=False, dispatch_watchdog_seconds=0)
                fmod, exc = tfault, TTimeout
            else:
                holder, oracle = jserved
                ex = JExecutor(holder, stats=Stats(),
                               count_batch_window=0.005,
                               solo_fastlane=False,
                               dispatch_watchdog_seconds=0)
                fmod, exc = jfault, JTimeout
            ps = _resident(ex, holder)
            fmod.set_fault("exec.dispatch_hang", "delay", times=1,
                           match={"kind": "rowcounts"},
                           args={"seconds": 0.6})
            results, errors = {}, {}
            start = threading.Barrier(2)

            def caller(name, deadline):
                try:
                    start.wait(10)
                    results[name] = np.asarray(ex.batcher.submit_rowcounts(
                        ps.plane, deadline=deadline))
                except Exception as e:  # noqa: BLE001
                    errors[name] = e

            ts = [threading.Thread(target=caller,
                                   args=("a", time.monotonic() + 0.25)),
                  threading.Thread(target=caller, args=("b", None))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert isinstance(errors.get("a"), exc), errors
            stages[pkg] = errors["a"].stage
            np.testing.assert_array_equal(results["b"][:N_ROWS], oracle)
            got = np.asarray(ex.batcher.submit_rowcounts(ps.plane))
            np.testing.assert_array_equal(got[:N_ROWS], oracle)
            fmod.clear()
            if pkg == "port":
                ex.close()
        assert stages["port"] == stages["reference"] == "dispatch"

    def test_mixed_kinds_with_deadline_churn_interleaved_ingest(
            self, tmp_path):
        """Readers of counts and compound trees stay exact while doomed
        callers churn tiny deadlines through the same windows and writers
        stream bits into the same plane: a doomed caller times out or
        answers exactly, never wrongly."""
        holder = THolder(str(tmp_path)).open()
        idx = holder.create_index("i")
        idx.create_field("f")
        ex = _ex(holder, delta_cells=32)
        rng = np.random.default_rng(17)
        counts = [0] * 4
        rows_l, cols_l = [], []
        for s in range(2):
            offs = rng.choice(SW // 2, size=64, replace=False)
            for r, o in zip(rng.integers(0, 4, size=64), offs):
                rows_l.append(int(r))
                cols_l.append(s * SW + int(o))
                counts[int(r)] += 1
        idx.field("f").import_bits(np.asarray(rows_l, np.uint64),
                                   np.asarray(cols_l, np.uint64))
        idx.note_columns(np.asarray(cols_l, np.uint64))
        sets = [set() for _ in range(4)]
        for r, c in zip(rows_l, cols_l):
            sets[r].add(c)
        tree = "Count(Intersect(Row(f=0), Union(Row(f=1), Row(f=2))))"
        tree_want = len(sets[0] & (sets[1] | sets[2]))
        for r in range(4):
            assert ex.execute("i", f"Count(Row(f={r}))") == [counts[r]]
        assert ex.execute("i", tree) == [tree_want]
        errors: list = []
        timeouts = [0]
        stop = time.monotonic() + 1.5
        start = threading.Barrier(17)

        def reader(i):
            try:
                start.wait(10)
                while time.monotonic() < stop:
                    if i % 2:
                        assert ex.execute("i", tree) == [tree_want]
                    else:
                        r = i % 4
                        got = ex.execute("i", f"Count(Row(f={r}))")
                        assert got == [counts[r]], got
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        def doomed(i):
            try:
                start.wait(10)
                while time.monotonic() < stop:
                    r = i % 4
                    try:
                        got = ex.execute("i", f"Count(Row(f={r}))",
                                         deadline=time.monotonic() + 0.002)
                    except TTimeout:
                        timeouts[0] += 1
                        continue
                    assert got == [counts[r]], f"doomed got {got}"
            except Exception as e:  # noqa: BLE001
                errors.append(f"doomed: {e!r}")

        def writer(w):
            wrng = np.random.default_rng(100 + w)
            try:
                start.wait(10)
                while time.monotonic() < stop:
                    s = int(wrng.integers(0, 2))
                    c = s * SW + SW // 2 + int(wrng.integers(0, SW // 2))
                    ex.execute("i", f"Set({c}, f=9)")
            except Exception as e:  # noqa: BLE001
                errors.append(f"writer: {e!r}")

        threads = ([threading.Thread(target=reader, args=(i,))
                    for i in range(10)]
                   + [threading.Thread(target=doomed, args=(i,))
                      for i in range(5)]
                   + [threading.Thread(target=writer, args=(w,))
                      for w in range(2)])
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors[:5]
            for r in range(4):
                assert ex.execute("i", f"Count(Row(f={r}))") == [counts[r]]
            assert ex.slots_in_use == 0
        finally:
            ex.close()
            holder.close()


class TestWatchdogQuarantine:
    def test_hung_dispatch_quarantined_and_recovers(self, served):
        """A hung launch: the window is quarantined (stage ``dispatch``),
        a fresh collector keeps serving, the governor degrades and probes
        back, and the superseded collector exits when the hang ends."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False,
                 dispatch_watchdog_seconds=5.0,
                 device_health_probe_seconds=0.1)
        try:
            assert ex.execute("i", "Count(Row(f=3))") == [int(oracle[3])]
            baseline = _census()
            _tighten(ex.batcher, 0.1)
            tfault.set_fault("exec.dispatch_hang", "delay", times=1,
                             args={"seconds": 1.0})
            t0 = time.monotonic()
            with pytest.raises(TStall) as ei:
                ex.execute("i", "Count(Row(f=3))")
            assert time.monotonic() - t0 < 0.9
            assert ei.value.stage == "dispatch"
            assert "quarantin" in str(ei.value)
            dh = ex.device_health()
            assert dh["watchdogTrips"] >= 1 and dh["quarantinedWindows"] >= 1
            _serve_until_healthy(ex, oracle, 5)
            census = _await_census(baseline)
            assert census["pilosa-torch-batcher"] <= \
                baseline["pilosa-torch-batcher"], (census, baseline)
        finally:
            ex.close()

    def test_hung_readback_quarantined(self, served):
        """A stalled readback: stage ``readback``, the reader superseded,
        exact answers afterwards, healthy again."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False,
                 dispatch_pipeline_depth=2, dispatch_watchdog_seconds=5.0,
                 device_health_probe_seconds=0.1)
        try:
            assert ex.execute("i", "Count(Row(f=1))") == [int(oracle[1])]
            baseline = _census()
            _tighten(ex.batcher, 0.1)
            tfault.set_fault("exec.readback_hang", "delay", times=1,
                             args={"seconds": 1.0})
            with pytest.raises(TStall) as ei:
                ex.execute("i", "Count(Row(f=1))")
            assert ei.value.stage == "readback"
            _serve_until_healthy(ex, oracle, 2)
            census = _await_census(baseline)
            assert census["pilosa-torch-readback"] <= \
                baseline["pilosa-torch-readback"], (census, baseline)
        finally:
            ex.close()

    def test_finish_window_failure_fails_items_not_wedges(self, served):
        """An exception escaping the readback fails the whole window with
        a stall error naming ``readback``; the next window serves."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False,
                 dispatch_pipeline_depth=2)
        try:
            ps = _resident(ex, holder)
            orig = ex.batcher._readback
            ex.batcher._readback = lambda w: (_ for _ in ()).throw(
                RuntimeError("synthetic readback explosion"))
            try:
                with pytest.raises(TStall) as ei:
                    ex.batcher.submit_rowcounts(ps.plane)
                assert ei.value.stage == "readback"
                assert "synthetic readback explosion" in str(ei.value)
            finally:
                ex.batcher._readback = orig
            got = ex.batcher.submit_rowcounts(ps.plane)
            np.testing.assert_array_equal(got[:N_ROWS], oracle)
        finally:
            ex.close()

    def test_collector_death_fails_backlog_immediately(self, served):
        """A collector cycle that dies with items queued fails them with
        a stall error naming ``collect``; the same thread keeps serving."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False)
        try:
            ps = _resident(ex, holder)
            b = ex.batcher
            orig = b._collect_once
            died = []

            def dying_collect():
                b._kick.wait()
                if not died:
                    died.append(True)
                    raise RuntimeError("synthetic collector death")
                return orig()

            b._collect_once = dying_collect
            try:
                h = b.enqueue_rowcounts(ps.plane)
                with pytest.raises(TStall) as ei:
                    b.wait(h)
                assert ei.value.stage == "collect"
                assert "collector failed" in str(ei.value)
            finally:
                b._collect_once = orig
            got = b.submit_rowcounts(ps.plane)
            np.testing.assert_array_equal(got[:N_ROWS], oracle)
        finally:
            ex.close()

    def test_no_thread_leak_after_repeated_quarantines(self, served):
        """Three quarantine-and-recover cycles leave no collector, reader
        or watchdog threads behind."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False,
                 dispatch_watchdog_seconds=5.0,
                 device_health_probe_seconds=0.05)
        try:
            assert ex.execute("i", "Count(Row(f=0))") == [int(oracle[0])]
            base_census = _census()
            base = threading.active_count()
            for _ in range(3):
                _tighten(ex.batcher, 0.08)
                tfault.set_fault("exec.dispatch_hang", "delay", times=1,
                                 args={"seconds": 0.6})
                with pytest.raises(TStall):
                    ex.execute("i", "Count(Row(f=0))")
                _serve_until_healthy(ex, oracle, 1)
            census = _await_census(base_census)
            for name, count in base_census.items():
                assert census[name] <= count, (census, base_census)
            end = time.monotonic() + 10
            while time.monotonic() < end:
                leaked = threading.active_count() - base
                if leaked <= 2:
                    break
                time.sleep(0.1)
            assert leaked <= 2, f"{leaked} threads leaked"
        finally:
            ex.close()

    def test_hung_group_fails_alone(self, served):
        """In a window of two groups, the hung group's items fail naming
        ``dispatch``; the other group's answers are exact."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.05, solo_fastlane=False,
                 dispatch_watchdog_seconds=0.3)
        try:
            ps = _resident(ex, holder)
            b = ex.batcher
            tfault.set_fault("exec.dispatch_hang", "delay", times=1,
                             match={"kind": "selcounts"},
                             args={"seconds": 1.0})
            h_sel = b._enqueue(TPending("selcounts", (1, 2), (ps.plane,)))
            h_row = b.enqueue_rowcounts(ps.plane)
            with pytest.raises(TStall) as ei:
                b.wait(h_sel)
            assert ei.value.stage == "dispatch"
            np.testing.assert_array_equal(b.wait(h_row)[:N_ROWS], oracle)
            assert b.governor.state == "degraded"
        finally:
            ex.close()


class TestGovernor:
    @pytest.mark.parametrize("gov", [TGovernor, JGovernor],
                             ids=["port", "reference"])
    def test_unit_transitions(self, gov):
        g = gov(probe_after_s=0.05)
        seen = [g.state]
        assert g.admit() and g.fastlane_ok()
        g.record_fault()
        g.record_fault()
        assert g.state == "healthy"
        g.record_success()
        g.record_fault()
        g.record_fault()
        assert g.state == "healthy"
        g.record_fault()
        seen.append(g.state)
        assert not g.admit() and not g.fastlane_ok()
        assert not g.pipelining_ok()
        time.sleep(0.06)
        assert g.admit()
        seen.append(g.state)
        assert not g.admit()
        g.record_fault()
        seen.append(g.state)
        time.sleep(0.06)
        assert g.admit()
        g.record_success()
        seen.append(g.state)
        g.record_trip()
        seen.append(g.state)
        assert seen == ["healthy", "degraded", "probing", "degraded",
                        "healthy", "degraded"]
        assert g.payload()["watchdogTrips"] == 1

    def test_payload_keys_equal(self):
        t = TGovernor().payload()
        j = JGovernor().payload()
        assert sorted(t) == sorted(j)
        assert t["kernelTier"] == "cuda"

    def test_degraded_serving_stays_exact_then_reprobes(self, served,
                                                        jserved):
        """Consecutive launch faults degrade the governor in both
        packages.  The port's faulted windows raise to their callers (the
        reference serves them item by item); every other answer is exact,
        degraded serving included, and a probe restores healthy."""
        runs = {}
        for pkg in ("port", "reference"):
            if pkg == "port":
                holder, oracle = served
                ex = _ex(holder, count_batch_window=0.002,
                         solo_fastlane=False,
                         device_health_probe_seconds=0.05)
                fmod = tfault
            else:
                holder, oracle = jserved
                ex = JExecutor(holder, stats=Stats(),
                               count_batch_window=0.002,
                               solo_fastlane=False,
                               device_health_probe_seconds=0.05)
                fmod = jfault
            assert ex.execute("i", "Count(Row(f=0))") == [int(oracle[0])]
            fmod.set_fault("exec.dispatch_error", "error", times=4)
            states, failed = [], 0
            end = time.monotonic() + 20
            i = 0
            while time.monotonic() < end:
                r = i % 8
                i += 1
                try:
                    got = ex.execute("i", f"Count(Row(f={r}))")
                    assert got == [int(oracle[r])]
                except fmod.FaultError:
                    assert pkg == "port"
                    failed += 1
                st = ex.batcher.governor.state
                if not states or states[-1] != st:
                    states.append(st)
                if st == "healthy" and "degraded" in states:
                    break
                time.sleep(0.01)
            runs[pkg] = (states, failed, ex.device_health())
            if pkg == "port":
                ex.close()
        for pkg, (states, failed, dh) in runs.items():
            assert states[0] == "healthy" and "degraded" in states, pkg
            assert states[-1] == "healthy", (pkg, states)
            assert dh["faultsTotal"] >= 3
        assert runs["port"][1] == 4  # the four faulted windows raised

    def test_fastlane_gated_off_while_degraded(self, served):
        holder, oracle = served
        ex = _ex(holder)
        try:
            assert ex.execute("i", "Count(Row(f=2))") == [int(oracle[2])]
            hits = ex.serving_stats()["fastLaneHits"]
            assert hits >= 1
            ex.batcher.governor.record_trip()
            assert ex.execute("i", "Count(Row(f=2))") == [int(oracle[2])]
            assert ex.serving_stats()["fastLaneHits"] == hits
        finally:
            ex.close()

    def test_degraded_failing_launch_reaches_its_caller(self, served):
        """Degraded serving launches each item alone through the same
        family calls: a launch that raises reaches that caller, never a
        plain fallback."""
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False)
        try:
            ex.batcher.governor.record_trip()
            ex.batcher.governor.probe_after_s = 60.0
            calls = []
            real = ex.fused.run_count_batch

            def refuse(*a, **k):
                calls.append(1)
                raise RuntimeError("launch refused")

            ex.fused.run_count_batch = refuse
            with pytest.raises(RuntimeError, match="launch refused"):
                ex.execute("i", "Count(Row(f=4))")
            assert calls == [1]
            ex.fused.run_count_batch = real
            assert ex.execute("i", "Count(Row(f=4))") == [int(oracle[4])]
            assert ex.batcher.governor.state == "degraded"
        finally:
            ex.close()


class TestKnobOffContract:
    def test_depth_one_watchdog_off_restores_inline_contract(self,
                                                             served):
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.001,
                 dispatch_pipeline_depth=1, dispatch_watchdog_seconds=0)
        try:
            for r in (2, 9):
                assert ex.execute("i", f"Count(Row(f={r}))") == \
                    [int(oracle[r])]
            b = ex.batcher
            assert b._readq is None and b._read_thread is None
            assert b._watchdog is None and not b._windows
            assert b.governor.state == "healthy"
            assert ex.device_health()["watchdogSeconds"] == 0.0
        finally:
            ex.close()

    def test_watchdog_on_happy_path_answers_unchanged(self, served):
        holder, oracle = served
        ex = _ex(holder, count_batch_window=0.002, solo_fastlane=False,
                 dispatch_watchdog_seconds=0.5)
        try:
            for _ in range(2):
                for r in range(N_ROWS):
                    assert ex.execute("i", f"Count(Row(f={r}))") == \
                        [int(oracle[r])]
            dh = ex.device_health()
            assert dh["watchdogTrips"] == 0 and dh["quarantinedWindows"] == 0
            assert dh["state"] == "healthy"
        finally:
            ex.close()


# -- device-OOM recovery ------------------------------------------------------


Q4 = "Count(Row(f=1))Count(Row(f=5))Count(Row(f=9))Count(Row(f=12))"


class TestDeviceOom:
    def test_classifier_is_a_type_test(self):
        assert _is_device_oom(torch.OutOfMemoryError("CUDA out of memory"))
        assert _is_device_oom(torch.cuda.OutOfMemoryError("x"))
        assert not _is_device_oom(RuntimeError("CUDA out of memory"))
        assert not _is_device_oom(ValueError("RESOURCE_EXHAUSTED"))
        with pytest.raises(torch.OutOfMemoryError):
            tfault.set_fault("s", "oom")
            tfault.fire("s")

    def test_stage_one_equal(self, served, jserved):
        """An OOM on the first attempt: both packages evict the unleased
        planes, retry once and answer the same."""
        holder, oracle = served
        ex = _ex(holder)
        jholder = jserved[0]
        jstats = Stats()
        jex = JExecutor(jholder, stats=jstats)
        try:
            want = [int(oracle[r]) for r in (1, 5, 9, 12)]
            assert ex.execute("i", "Count(Row(f=3))Count(Row(f=4))") == \
                jex.execute("i", "Count(Row(f=3))Count(Row(f=4))")
            ev = ex.planes.evictions
            assert ex.planes.stats()["entries"] >= 1
            tfault.set_fault("exec.oom", "oom", times=1)
            jfault.set_fault("exec.oom", "oom", times=1)
            assert ex.execute("i", Q4) == want == jex.execute("i", Q4)
            st = ex.serving_stats()
            jc = jstats.snapshot()["counters"]
            assert st["deviceOomRetries"] == 1 == sum(
                jc["device_oom_retries"].values())
            assert st["deviceOomExclusiveRetries"] == 0
            assert "device_oom_exclusive_retries" not in jc
            assert ex.planes.evictions > ev
            assert st["lastDeviceOom"]["stage"] == 1
            assert ex.slots_in_use == 0 and not ex.planes._leases
        finally:
            ex.close()

    def test_stage_two_equal(self, served, jserved):
        """The stage-1 retry OOMs too: drain to exclusivity, drop all
        residency, answer.  The port's ``exec.oom`` fires on each attempt
        (times=2); the reference's fires once per call, so it is driven by
        its own test's recipe, a plane build that raises twice."""
        holder, oracle = served
        ex = _ex(holder)
        jholder = jserved[0]
        jstats = Stats()
        jex = JExecutor(jholder, stats=jstats)

        class XlaRuntimeError(Exception):
            pass

        try:
            pql = "TopN(f, n=5)"
            want = jex.execute("i", pql)[0].pairs
            assert [(p.id, p.count) for p in ex.execute("i", pql)[0].pairs] \
                == [(p.id, p.count) for p in want]
            tfault.set_fault("exec.oom", "oom", times=2)
            real = jex.planes._build_plane
            fails = {"n": 2}

            def flaky(field, view_name, shards):
                if fails["n"] > 0:
                    fails["n"] -= 1
                    raise XlaRuntimeError("RESOURCE_EXHAUSTED: out of memory")
                return real(field, view_name, shards)

            jex.planes.invalidate()
            jex.planes._build_plane = flaky
            got_t = ex.execute("i", pql)[0].pairs
            got_j = jex.execute("i", pql)[0].pairs
            assert [(p.id, p.count) for p in got_t] == \
                [(p.id, p.count) for p in got_j] == \
                [(p.id, p.count) for p in want]
            st = ex.serving_stats()
            jc = jstats.snapshot()["counters"]
            assert (st["deviceOomRetries"], st["deviceOomExclusiveRetries"]) \
                == (sum(jc["device_oom_retries"].values()),
                    sum(jc["device_oom_exclusive_retries"].values())) \
                == (1, 1)
            assert ex.planes.stats()["entries"] <= 1  # all residency dropped
            assert ex.slots_in_use == 0 and jex._inflight == 0
        finally:
            ex.close()

    def test_quoted_out_of_memory_does_not_evict(self, served):
        """An error that quotes "out of memory" is not a device OOM: the
        cache keeps its planes and no recovery runs."""
        holder, oracle = served
        ex = _ex(holder)
        try:
            assert ex.execute("i", Q4) == [int(oracle[r])
                                           for r in (1, 5, 9, 12)]
            entries = ex.planes.stats()["entries"]
            ev = ex.planes.evictions
            for pql in ('Count(Row(f="CUDA out of memory"))',
                        'Count(Row(out_of_memory=1))'):
                with pytest.raises(Exception) as ei:
                    ex.execute("i", pql)
                assert not isinstance(ei.value, torch.OutOfMemoryError)
            ex.fused.run_selected_counts = lambda *a, **k: (_ for _ in ()) \
                .throw(RuntimeError("CUDA out of memory (not really)"))
            with pytest.raises(RuntimeError):
                ex.execute("i", "Count(Row(f=1))Count(Row(f=2))")
            assert ex.planes.evictions == ev
            assert ex.planes.stats()["entries"] == entries
            assert ex.serving_stats()["deviceOomRetries"] == 0
        finally:
            ex.close()

    def test_oom_recovery_under_concurrency(self, served):
        """Eight concurrent queries each hit a device OOM once: all
        recover and answer exactly, and no in-flight bookkeeping or lease
        is left behind."""
        holder, oracle = served
        ex = _ex(holder)
        try:
            pql = "TopN(f, n=3)"
            expected = ex.execute("i", pql)[0].pairs
            real = ex.planes._build_plane
            seen: set = set()
            lock = threading.Lock()

            def flaky(*a, **k):
                with lock:
                    first = threading.get_ident() not in seen
                    seen.add(threading.get_ident())
                if first:
                    raise torch.OutOfMemoryError("CUDA out of memory")
                return real(*a, **k)

            ex.planes.invalidate()
            ex.planes._build_plane = flaky
            results, errors = {}, []
            start = threading.Barrier(8)

            def worker(i):
                try:
                    start.wait(10)
                    results[i] = ex.execute("i", pql)[0].pairs
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            assert not errors, errors[:3]
            assert seen and all(results[i] == expected for i in range(8))
            assert ex.slots_in_use == 0 and not ex.planes._leases
            assert ex.serving_stats()["deviceOomRetries"] >= 1
        finally:
            ex.close()


# -- the distinct kind --------------------------------------------------------


@pytest.fixture(scope="module")
def bsi_dirs(tmp_path_factory):
    """Index ``b`` with a BSI field ``v`` (values in [-500, 500], half the
    columns of 2 shards) and a set field ``s``, written through the
    reference's API, and the reference's Distinct answers."""
    base = tmp_path_factory.mktemp("distinct")
    root = str(base / "src")
    h = JHolder(root).open()
    api = JAPI(h, JExecutor(h))
    api.create_index("b")
    api.create_field("b", "v", {"type": "int", "min": -500, "max": 500})
    api.create_field("b", "s")
    rng = np.random.default_rng(5)
    cols = rng.choice(2 * SW, 6000, replace=False)
    vals = rng.integers(-500, 501, len(cols))
    api.import_values("b", "v", col_ids=cols.tolist(), values=vals.tolist())
    api.import_bits("b", "s", row_ids=[1] * 3000,
                    col_ids=cols[::2].tolist())
    want = {q: api.executor.execute("b", q)[0].values for q in DISTINCTS}
    h.close()
    return {"want": want, "t": root}


DISTINCTS = ("Distinct(field=v)", "Distinct(Row(s=1), field=v)")


def test_distinct_kind_dedupes_and_equals_reference(bsi_dirs):
    """Concurrent identical Distincts share one presence scan per window;
    different ones scan apart; every answer equals the reference's."""
    want = bsi_dirs["want"]
    th = THolder(bsi_dirs["t"]).open()
    ex = _ex(th, count_batch_window=0.05)
    try:
        for q in DISTINCTS:
            assert ex.execute("b", q)[0].values == want[q]
        before = ex.serving_stats()
        got, errors = [], []
        start = threading.Barrier(8)

        def client(k):
            try:
                start.wait(10)
                q = DISTINCTS[k % 2]
                got.append((q, ex.execute("b", q)[0].values))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errors, errors
        assert len(got) == 8 and all(v == want[q] for q, v in got)
        after = ex.serving_stats()
        scans = after["distinctScans"] - before["distinctScans"]
        windows = after["distinctWindows"] - before["distinctWindows"]
        assert 1 <= windows and 2 <= scans < 8, (scans, windows)
        assert after["kinds"]["distinct"]["maxItems"] >= 2
    finally:
        ex.close()
        th.close()



# -- the API's bodies ---------------------------------------------------------


def _apis(served, jserved, **kw):
    holder, _ = served
    tapi = TAPI(holder, _ex(holder, **kw.get("ex", {})),
                query_timeout=kw.get("cap", 0.0))
    jex = JExecutor(jserved[0], stats=Stats(), **kw.get("ex", {}))
    japi = JAPI(jserved[0], jex, query_timeout=kw.get("cap", 0.0),
                trace_sample_rate=0.0, slow_query_threshold=0.0)
    return tapi, japi


def _api_error(api, exc, *a, **k):
    with pytest.raises(exc) as ei:
        api.query(*a, **k)
    return ei.value


def test_504_body_at_a_call_boundary_equal(served, jserved):
    """A deadline that passes before the second call: 504, the timeout
    block with the same keys, budget and (no) stage in both packages."""
    tapi, japi = _apis(served, jserved)
    try:
        pql = "Count(Row(f=1))Row(f=2)"
        for fmod in (tfault, jfault):
            fmod.set_fault("exec.execute", "delay", args={"seconds": 0.3})
        errs = [_api_error(tapi, TApiError, "i", pql, timeout=0.1),
                _api_error(japi, JApiError, "i", pql, timeout=0.1)]
        t, j = (e.extra["timeout"] for e in errs)
        assert errs[0].status == errs[1].status == 504
        assert sorted(t) == sorted(j)
        assert {k: t[k] for k in t if k != "elapsedSeconds"} == \
            {k: j[k] for k in j if k != "elapsedSeconds"}
        assert t["stage"] is None and t["deadlineSeconds"] == 0.1
        assert t["elapsedSeconds"] >= 0.1
        assert str(errs[0]) == str(errs[1])
    finally:
        tapi.executor.close()


def test_504_body_in_the_pipeline_equal(served, jserved):
    """A deadline that passes while the item waits in a stalled window:
    504 naming the same stage in both packages, then exact answers."""
    cfg = {"ex": {"count_batch_window": 0.002, "solo_fastlane": False,
                  "dispatch_watchdog_seconds": 0}}
    tapi, japi = _apis(served, jserved, **cfg)
    oracle = served[1]
    try:
        bodies = []
        for api, fmod, exc in ((tapi, tfault, TApiError),
                               (japi, jfault, JApiError)):
            api.query("i", "Count(Row(f=6))")
            fmod.set_fault("exec.dispatch_hang", "delay", times=1,
                           args={"seconds": 0.5})
            e = _api_error(api, exc, "i", "Count(Row(f=6))", timeout=0.15)
            assert e.status == 504
            bodies.append(e.extra["timeout"])
            time.sleep(0.5)
            assert api.query("i", "Count(Row(f=6))")["results"] == \
                [int(oracle[6])]
        assert sorted(bodies[0]) == sorted(bodies[1])
        assert bodies[0]["stage"] == bodies[1]["stage"] == "dispatch"
        assert tapi.executor.slots_in_use == 0
    finally:
        tapi.executor.close()


def test_500_pipeline_stall_body_equal(served, jserved):
    """A quarantined window answers 500 with the same ``pipelineStall``
    keys and stage in both packages."""
    cfg = {"ex": {"count_batch_window": 0.002, "solo_fastlane": False,
                  "dispatch_watchdog_seconds": 5.0,
                  "device_health_probe_seconds": 0.05}}
    tapi, japi = _apis(served, jserved, **cfg)
    try:
        blocks = []
        for api, fmod, exc in ((tapi, tfault, TApiError),
                               (japi, jfault, JApiError)):
            api.query("i", "Count(Row(f=7))")
            _tighten(api.executor.batcher, 0.5)
            fmod.set_fault("exec.readback_hang", "delay", times=1,
                           args={"seconds": 1.5})
            e = _api_error(api, exc, "i", "Count(Row(f=7))")
            assert e.status == 500
            assert api.executor.device_health()["watchdogTrips"] == 1
            blocks.append(e.extra["pipelineStall"])
        assert sorted(blocks[0]) == sorted(blocks[1]) == \
            ["elapsedSeconds", "stage"]
        assert blocks[0]["stage"] == blocks[1]["stage"] == "readback"
    finally:
        tapi.executor.close()


@pytest.mark.parametrize("cap, asked, budget", [
    (0.0, None, None), (0.0, 0, None), (0.2, None, 0.2), (0.2, 0, 0.2),
    (0.2, 5.0, 0.2), (0.2, 0.1, 0.1), (0.0, 0.15, 0.15)])
def test_timeout_cap(served, jserved, cap, asked, budget):
    """``query_timeout`` caps every request's timeout and 0 means the
    cap, as in the reference: the 504's ``deadlineSeconds`` is the
    budget the query ran under."""
    tapi, japi = _apis(served, jserved, cap=cap)
    try:
        got = []
        for api, fmod, exc in ((tapi, tfault, TApiError),
                               (japi, jfault, JApiError)):
            fmod.set_fault("exec.execute", "delay", times=1,
                           args={"seconds": (budget or 0) + 0.05})
            if budget is None:
                assert api.query("i", "Count(Row(f=1))Row(f=1)",
                                 timeout=asked)["results"][0] >= 0
                got.append(None)
            else:
                e = _api_error(api, exc, "i", "Count(Row(f=1))Row(f=1)",
                               timeout=asked)
                got.append(e.extra["timeout"]["deadlineSeconds"])
            fmod.clear()
        assert got[0] == got[1] == budget
    finally:
        tapi.executor.close()


def test_status_device_health_keys(served, jserved):
    """``/status``'s deviceHealth block carries the reference's keys
    (``warmup`` is not ported: the port compiles no per-shape program)."""
    for kw in ({}, {"count_batch_window": "off"}):
        tapi, japi = _apis(served, jserved, ex=kw)
        try:
            t = tapi.status()["deviceHealth"]
            j = japi.executor.device_health()
            assert sorted(t) == sorted(k for k in j if k != "warmup")
            assert t["state"] == "healthy" and t["kernelTier"] == "plain"
        finally:
            tapi.executor.close()


@pytest.mark.parametrize("spec", [
    {"nth": 3}, {"nth": 2, "times": 2}, {"prob": 0.5, "seed": 7},
    {"prob": 0.3, "seed": 1, "times": 4}, {"match": {"kind": "count"}}])
def test_fault_registry_fires_as_the_reference(spec):
    """The same failpoint schedule fires on the same hits in both
    registries, armed directly or through ``configure``."""
    hits = []
    for mod in (jfault, tfault):
        mod.clear()
        assert mod.configure([{"site": "s", "action": "error", **spec}]) == 1
        assert [f["site"] for f in mod.list_faults()] == ["s"]
        fired = []
        for i in range(20):
            try:
                mod.fire("s", kind="count" if i % 3 else "tree")
                fired.append(False)
            except mod.FaultError:
                fired.append(True)
        hits.append(fired)
        assert mod.clear("s") == 1 and not mod.ACTIVE
    assert hits[0] == hits[1] and any(hits[1])
    with pytest.raises(ValueError, match="unknown fault action"):
        tfault.set_fault("s", "bogus")
    with pytest.raises(ValueError, match="unknown fault action"):
        jfault.set_fault("s", "bogus")
