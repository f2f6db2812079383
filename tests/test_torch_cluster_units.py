"""The cluster's host pieces in the port against the JAX package's, with
no cluster running:

- jump-hash placement (``jump_hash``, ``shard_nodes``) over several node
  lists and replica counts;
- the ``IdWindow`` file (appends, compaction, a torn tail) and the hint
  log (appends through the ``hints.append`` torn-write failpoint, acks,
  recovery) byte for byte;
- the op-log's ``oplog.append`` torn write and the ``sys.write`` /
  ``sys.fsync`` / ``sys.mmap`` failpoints;
- ``Fragment.blocks`` / ``block_positions`` / ``merge_positions`` /
  ``rebuild_from_positions`` on fragments of both packages, with their
  snapshot bytes;
- a roaring import of rows a fragment does not hold (its native fast
  path) and the snapshot made from rows held as words: op-log and
  snapshot bytes over dense, sparse, runny and mixed rows;
- ``merge_results`` over the same partials for every call kind it merges,
  and the breaker board's transitions.
"""

import os

import numpy as np
import pytest

from pilosa_tpu import fault as jfault
from pilosa_tpu.cluster import breaker as jbreaker
from pilosa_tpu.cluster import hints as jhints
from pilosa_tpu.cluster.dist import merge_results as jmerge
from pilosa_tpu.parallel import placement as jplace
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu.store import oplog as joplog
from pilosa_tpu.store.fragment import Fragment as JFragment
from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.cluster import breaker as tbreaker
from pilosa_tpu_torch.cluster import hints as thints
from pilosa_tpu_torch.cluster.dist import merge_results as tmerge
from pilosa_tpu_torch.parallel import placement as tplace
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.store import oplog as toplog
from pilosa_tpu_torch.store import syswrap as tsyswrap
from pilosa_tpu_torch.store.fragment import Fragment as TFragment
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
PKG = {"jax": (jfault, jhints, joplog, JFragment),
       "torch": (tfault, thints, toplog, TFragment)}


@pytest.fixture(autouse=True)
def _no_faults():
    for f in (jfault, tfault):
        f.clear()
    yield
    for f in (jfault, tfault):
        f.clear()


@pytest.mark.parametrize("nodes,replicas", [
    (["127.0.0.1:101", "127.0.0.1:102", "127.0.0.1:103"], 2),
    (["b:1", "a:1", "c:2", "d:9"], 1),
    (["n%d" % i for i in range(7)], 3),
])
def test_placement_equal(nodes, replicas):
    for key in (0, 1, 2**63 + 5, 123456789):
        assert tplace.jump_hash(key, 17) == jplace.jump_hash(key, 17)
    for index in ("i", "bench", "k"):
        for shard in range(40):
            assert (tplace.shard_nodes(index, shard, nodes, replicas)
                    == jplace.shard_nodes(index, shard, nodes, replicas))


def test_id_window_bytes_equal(tmp_path):
    files = {}
    for pkg, (_, _, oplog, _) in PKG.items():
        path = str(tmp_path / pkg / "_hints_applied.log")
        w = oplog.IdWindow(path, cap=4)
        for i in range(11):  # past 2 * cap: one compaction
            assert w.add(f"{i:032x}") is True
        assert w.add(f"{10:032x}") is False
        assert f"{9:032x}" in w and f"{1:032x}" not in w
        w.close()
        with open(path, "ab") as f:
            f.write(b"\x01\x02\x03")  # a torn tail
        w2 = oplog.IdWindow(path, cap=4)
        assert len(w2) == 4 and f"{10:032x}" in w2
        w2.close()
        with open(path, "rb") as f:
            files[pkg] = f.read()
    assert files["torch"] == files["jax"]


def test_hint_log_bytes_equal(tmp_path, monkeypatch):
    files = {}
    for pkg, (fault, hints, _, _) in PKG.items():
        monkeypatch.setattr(hints.time, "time", lambda: 1.7e9)
        board = hints.HintBoard(str(tmp_path / pkg / "_hints"), max_age=60)
        recs = [{"id": f"{i:032x}", "index": "i", "pql": f"Set({i}, f=1)",
                 "op": "Set", "field": "f", "shards": [0]}
                for i in range(5)]
        for r in recs[:3]:
            board.add("127.0.0.1:9", r)
        fault.set_fault("hints.append", "torn_write", nth=1,
                        args={"offset": 9})
        with pytest.raises(fault.FaultError):
            board.add("127.0.0.1:9", recs[3])
        fault.clear()
        board.add("127.0.0.1:9", recs[4])
        assert board.pending_ops("127.0.0.1:9") == 4
        assert board.gated_fragment("i", "f", 0)
        assert not board.gated_fragment("i", "f", 1)
        batch = board.peek("127.0.0.1:9", 2)
        assert board.ack("127.0.0.1:9", batch[-1][0]) == 2
        summary = board.summary()
        assert summary["hintBacklogOps"] == 2
        board.close()
        again = hints.HintBoard(str(tmp_path / pkg / "_hints"), max_age=60)
        assert [r for _, r in again.peek("127.0.0.1:9", 9)] == [
            recs[2], recs[4]]
        again.close()
        name = os.listdir(tmp_path / pkg / "_hints")[0]
        with open(tmp_path / pkg / "_hints" / name, "rb") as f:
            files[pkg] = (name, f.read())
    assert files["torch"] == files["jax"]


def test_oplog_torn_append_recovers_equal(tmp_path):
    files = {}
    for pkg, (fault, _, oplog, _) in PKG.items():
        log = oplog.OpLog(str(tmp_path / f"{pkg}.oplog"))
        log.append(oplog.OP_SET_BITS, 0, np.arange(5, dtype=np.uint64))
        fault.set_fault("oplog.append", "torn_write", nth=1,
                        args={"offset": 7})
        with pytest.raises(fault.FaultError):
            log.append(oplog.OP_SET_BITS, 0, np.arange(9, dtype=np.uint64))
        fault.clear()
        log.append(oplog.OP_CLEAR_ROW, 3)
        log.close()
        got = [(op, aux, None if p is None else p.tolist())
               for op, aux, p in oplog.OpLog(log.path).replay()]
        assert got == [(1, 0, [0, 1, 2, 3, 4]), (3, 3, None)]
        with open(log.path, "rb") as f:
            files[pkg] = f.read()
    assert files["torch"] == files["jax"]


@pytest.mark.parametrize("site", ["sys.write", "sys.fsync"])
def test_sys_write_and_fsync_failpoints(tmp_path, site):
    path = tmp_path / "x"
    with open(path, "wb") as f:
        tfault.set_fault(site, "error", args={"errno": "ENOSPC"})
        with pytest.raises(tfault.FaultError) as ei:
            tsyswrap.checked_write(f, b"abc")
            f.flush()
            tsyswrap.checked_fsync(f)
        assert ei.value.errno == 28
    tfault.clear()
    with open(path, "wb") as f:
        tfault.set_fault("sys.write", "torn_write", args={"offset": 2})
        with pytest.raises(tfault.FaultError):
            tsyswrap.checked_write(f, b"abcdef")
    assert path.read_bytes() == b"ab"


def test_sys_mmap_failpoint():
    class Frag:
        path = "/x/0"
    tfault.set_fault("sys.mmap", "error", match={"path": "/x/"})
    pool = tsyswrap.MapPool(max_maps=4)
    with pytest.raises(tfault.FaultError):
        pool.register(Frag())
    assert pool.live == 0


def _frags(tmp_path):
    out = {}
    for pkg, (_, _, _, frag_cls) in PKG.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = frag_cls(str(d / "0"), 0).open()
    return out


def test_fragment_aae_functions_equal(tmp_path):
    rng = np.random.default_rng(5)
    base = np.unique(rng.integers(0, 350 * SW, 3000).astype(np.uint64))
    more = np.unique(rng.integers(0, 350 * SW, 500).astype(np.uint64))
    frags = _frags(tmp_path)
    out = {}
    for pkg, frag in frags.items():
        rows, cols = base // SW, base % SW
        frag.set_bits(rows, cols)
        b0 = frag.blocks()
        assert frag.blocks() is b0  # cached per generation
        changed = frag.merge_positions(more)
        b1 = frag.blocks()
        blk = {b: frag.block_positions(b).tolist() for b in b1}
        frag.snapshot()
        with open(frag.path, "rb") as f:
            snap = f.read()
        frag.rebuild_from_positions(more)
        with open(frag.path, "rb") as f:
            rebuilt = f.read()
        out[pkg] = (b0, changed, b1, blk, snap, rebuilt,
                    frag.positions().tolist(), frag.op_n)
        frag.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == len(np.setdiff1d(more, base))
    assert out["torch"][6] == more.tolist()


def test_dense_rows_positions_and_blocks_equal(tmp_path):
    """Rows held as packed words (consecutive ids, a gap, one in another
    checksum block) give the reference's positions, block checksums and
    block positions: whole-dense, then mixed with a sparse row after a
    single-bit write, then after a union-merge into those rows."""
    from pilosa_tpu_torch.store import roaring as troaring
    rng = np.random.default_rng(6)
    ids = np.array([0, 1, 2, 3, 9, 150], np.uint64)
    words = (rng.integers(0, 1 << 32, (len(ids), 32768), dtype=np.uint32)
             & rng.integers(0, 1 << 32, (len(ids), 32768), dtype=np.uint32))
    words[1, :100] = 0  # a row whose first containers are empty
    blob = troaring.serialize_dense(words, ids)
    more = np.unique(rng.integers(0, 160 * SW, 4000).astype(np.uint64))
    out = {}
    for pkg, frag in _frags(tmp_path).items():
        frag.import_roaring(blob)
        states = [(frag.positions().tolist(), frag.blocks())]
        frag.set_bits(np.array([40], np.uint64), np.array([5], np.uint64))
        states.append((frag.positions().tolist(), frag.blocks()))
        frag.merge_positions(more)
        b = frag.blocks()
        states.append((frag.positions().tolist(), b,
                       {k: frag.block_positions(k).tolist() for k in b}))
        out[pkg] = states
        frag.close()
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0][1]) == 2  # rows 0-9 and row 150


def _merge_cases():
    pairs = [[{"id": 1, "count": 5}, {"id": 2, "count": 3}],
             [{"id": 2, "count": 4}, {"id": 7, "count": 1}]]
    tani = [{"pairs": [{"id": 1, "count": 3, "rowCount": 9}],
             "srcCount": 5},
            {"pairs": [{"id": 1, "count": 2, "rowCount": 2},
                       {"id": 4, "count": 1, "rowCount": 8}],
             "srcCount": 3}]
    groups = [[{"group": [{"field": "f", "rowID": 1}], "count": 3,
                "agg": 10},
               {"group": [{"field": "f", "rowID": 2}], "count": 1,
                "agg": -4}],
              [{"group": [{"field": "f", "rowID": 1}], "count": 2,
                "agg": 7}]]
    return [
        ("Count(Row(f=1))", [3, 4, 0]),
        ("Set(1, f=1)", [False, True]),
        ("Row(f=1)", [{"columns": [5, 9]}, {"columns": [1, 9, 30]}]),
        ("All(limit=2, offset=1)", [{"columns": [5, 9]},
                                   {"columns": [1, 30]}]),
        ("TopN(f, n=2)", pairs),
        ("TopN(f)", pairs),
        ("TopN(f, tanimoto=40)", tani),
        ("Sum(field=a)", [{"value": 5, "count": 2},
                          {"value": -3, "count": 1}]),
        ("Min(field=a)", [{"value": 5, "count": 2},
                          {"value": 5, "count": 1},
                          {"value": 0, "count": 0}]),
        ("Max(field=a)", [{"value": 5, "count": 2},
                          {"value": 9, "count": 1}]),
        ("Distinct(field=a)", [{"values": [3, 1]}, {"values": [2, 3]}]),
        ("Rows(f, limit=3)", [{"rows": [4, 1]}, {"rows": [2, 9]}]),
        ("GroupBy(Rows(f))", groups),
        ("GroupBy(Rows(f), aggregate=Min(field=a))", groups),
        ("GroupBy(Rows(f), aggregate=Max(field=a), limit=1)", groups),
        ("GroupBy(Rows(f), aggregate=Sum(field=a), "
         "having=Condition(count > 3))", groups),
        ("Extract(All(), Rows(f))", [
            {"fields": [{"name": "f", "type": "set"}],
             "columns": [{"column": 9, "rows": [[1]]}]},
            {"fields": [{"name": "f", "type": "set"}],
             "columns": [{"column": 3, "rows": [[2]]}]}]),
    ]


@pytest.mark.parametrize("pql,partials", _merge_cases())
def test_merge_results_equal(pql, partials):
    import copy
    want = jmerge(jparse(pql).calls[0], copy.deepcopy(partials))
    got = tmerge(tparse(pql).calls[0], copy.deepcopy(partials))
    assert got == want


def test_breaker_transitions_equal():
    seqs = {}
    for pkg, mod in (("jax", jbreaker), ("torch", tbreaker)):
        board = mod.BreakerBoard(threshold=2)
        seq = []
        for step in ("f", "f", "probe", "f", "probe", "s", "f", "reset"):
            if step == "f":
                board.record_failure("p")
            elif step == "s":
                board.record_success("p")
            elif step == "probe":
                board.begin_probe("p")
            else:
                board.reset("p")
            seq.append((board.state("p"), sorted(board.unhealthy_peers())))
        seqs[pkg] = seq
    assert seqs["torch"] == seqs["jax"]
    assert ("open", ["p"]) in seqs["torch"]


def _rows_words(kind: str, rng) -> np.ndarray:
    """uint32[8, 32768] rows of one shape: dense, sparse, runny, mixed."""
    w = np.zeros((8, 32768), np.uint32)
    if kind == "dense":
        w[:] = (rng.integers(0, 1 << 32, w.shape, dtype=np.uint32)
                & rng.integers(0, 1 << 32, w.shape, dtype=np.uint32))
    elif kind == "sparse":
        for r in range(8):
            cols = rng.choice(1 << 20, 3000, replace=False)
            np.bitwise_or.at(w[r], cols >> 5,
                             np.uint32(1) << (cols & 31).astype(np.uint32))
    elif kind == "runs":
        w[:, ::3] = 0xFFFFFFFF
    else:  # dense rows beside a sparse one, an empty one and a run row
        w[:] = rng.integers(0, 1 << 32, w.shape, dtype=np.uint32)
        w[2] = 0
        w[3, 5:] = 0
        w[4, :4096] = 0xFFFFFFFF
    return w


@pytest.mark.parametrize("kind", ["dense", "sparse", "runs", "mixed"])
def test_new_rows_import_and_snapshot_bytes_equal(tmp_path, kind):
    """A roaring import of rows a fragment does not hold, then its
    compaction: op-log and snapshot bytes equal the reference's, and a
    second import over the same rows takes the general path equally."""
    from pilosa_tpu_torch.store import roaring as troaring
    rng = np.random.default_rng(len(kind))
    words = _rows_words(kind, rng)
    blob = troaring.serialize_dense(words,
                                    np.arange(8, dtype=np.uint64) * 7 + 1)
    more = troaring.serialize(np.unique(rng.integers(
        0, 60 * SW, 5000).astype(np.uint64)))
    out = {}
    for pkg, frag in _frags(tmp_path).items():
        changed = [frag.import_roaring(blob), frag.import_roaring(more)]
        with open(frag.path + ".oplog", "rb") as f:
            log = f.read()
        frag.snapshot()
        with open(frag.path, "rb") as f:
            snap = f.read()
        out[pkg] = (changed, log, snap, frag.generation)
        frag.close()
    assert out["torch"] == out["jax"]


def test_hint_log_scrub_verdicts_equal(tmp_path):
    """The scrubber's hint-log verdict, clean and after a flipped byte,
    is the reference's."""
    from pilosa_tpu.store import scrub as jscrub
    from pilosa_tpu_torch.store import scrub as tscrub
    board = thints.HintBoard(str(tmp_path / "_hints"), max_age=60)
    for i in range(3):
        board.add("p:1", {"id": f"{i:032x}", "index": "i",
                          "pql": f"Set({i}, f=1)", "op": "Set",
                          "field": "f", "shards": [0]})
    board.close()
    path = str(tmp_path / "_hints" / os.listdir(tmp_path / "_hints")[0])
    verdicts = [(m.verify_hintlog_file(path)) for m in (jscrub, tscrub)]
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    verdicts += [(m.verify_hintlog_file(path)) for m in (jscrub, tscrub)]
    assert verdicts[0] == verdicts[1] and verdicts[0][0] is None
    assert verdicts[2] == verdicts[3] and verdicts[2][0] is not None


def test_aae_converges_a_block_under_a_steady_writer(tmp_path,
                                                     monkeypatch):
    """A block that the peer keeps writing still converges: each round
    pushes this copy's bits whatever landed on the peer since its
    checksums were read (the reference's push), so the diverged bit
    reaches the peer in the first round, and one quiet round after the
    writer stops leaves both copies equal."""
    from pilosa_tpu_torch.testing import run_cluster
    with run_cluster(2, str(tmp_path), replicas=2, device="cpu") as c:
        cl = c.client(0)
        cl.create_index("ae", {"trackExistence": False})
        cl.create_field("ae", "f")
        assert cl.query("ae", "Set(1, f=1)") == [True]
        a, b = c.servers
        fa, fb = (s.holder.index("ae").field("f").standard_view()
                  .fragment(0) for s in (a, b))
        # diverged below the cluster: only a holds (1, 50)
        fa.set_bits(np.array([1], np.uint64), np.array([50], np.uint64))
        real = a.cluster._client
        written = []

        class Writing:
            """b's client, with a write landing on b's block after each
            pull of it: a writer that never pauses for the round."""

            def __init__(self, inner):
                self.inner = inner

            def _do(self, method, path, *args, **kw):
                out = self.inner._do(method, path, *args, **kw)
                if "/internal/fragment/data" in path:
                    col = 60 + len(written)
                    fb.set_bits(np.array([1], np.uint64),
                                np.array([col], np.uint64))
                    written.append(SW + col)
                return out

            def __getattr__(self, name):
                return getattr(self.inner, name)

        monkeypatch.setattr(a.cluster, "_client",
                            lambda peer: Writing(real(peer)))
        for _ in range(3):
            assert a.cluster.sync_once() >= 1
            assert SW + 50 in fb.positions().tolist()
        assert len(written) == 3
        monkeypatch.setattr(a.cluster, "_client", real)
        assert a.cluster.sync_once() >= 1
        assert fa.positions().tolist() == fb.positions().tolist() == [
            SW + 1, SW + 50, *written]
