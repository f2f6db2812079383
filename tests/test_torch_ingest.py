"""Ingest while serving in the port, against ``pilosa_tpu``.

The same numpy inputs, made from a seed, go through
``pilosa_tpu.ingest.delta`` and ``pilosa_tpu_torch.ingest.delta`` (the
merge of a base plane with a delta overlay, the host mirror), through
both packages' ``Fragment`` mutation journals, and, end to end, through
REST ``/import`` batches interleaved with queries against both APIs.
Everything is an exact integer count or word: the tolerance is 0.
"""

import json
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ingest import delta as jdelta
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu.store.fragment import Fragment as JFragment
from pilosa_tpu_torch.api import ApiError
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec.planes import _apply_plane_cells
from pilosa_tpu_torch.ingest import delta as tdelta
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.store.fragment import Fragment as TFragment
from test_torch_slice import (COUNTS, READS, SHARDS, _get, _jax_api,
                              _port_api, _post, _write_index)

SW = 1 << 20


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/int numpy -> the port's int32 CPU tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _plane_and_overlay(seed: int, s: int = 3, r: int = 4, w: int = 40,
                       n: int = 11, c_pad: int = 16):
    """A ~25% dense uint32 plane with 0x80000000 / 0xFFFFFFFF words, a
    filter, and an overlay of ``n`` live cells padded to ``c_pad`` lanes
    with the out-of-range row ``s * r``; cell values include the sign-bit
    and all-ones words."""
    rng = np.random.default_rng(seed)
    plane = (rng.integers(0, 1 << 32, (s, r, w), dtype=np.uint32)
             & rng.integers(0, 1 << 32, (s, r, w), dtype=np.uint32))
    plane[:, :, 0] = 0x80000000
    plane[:, :, -1] = 0xFFFFFFFF
    filt = rng.integers(0, 1 << 32, (s, w), dtype=np.uint32)
    filt[:, 1] = 0xFFFFFFFF
    cells = rng.choice(s * r * w, n, replace=False)
    rows = np.full(c_pad, s * r, np.int32)
    words = np.zeros(c_pad, np.int32)
    vals = np.zeros(c_pad, np.uint32)
    rows[:n] = cells // w
    words[:n] = cells % w
    vals[:n] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    vals[0], vals[1], vals[2] = 0x80000000, 0xFFFFFFFF, 0
    words[3] = w - 1          # an all-ones base word overwritten
    return plane, filt, rows, words, vals


@pytest.mark.parametrize("filtered", [False, True])
def test_cell_diffs_equal(filtered):
    plane, filt, rows, words, vals = _plane_and_overlay(1)
    f = filt if filtered else None
    jd, js = jdelta._cell_diffs(jnp.asarray(plane), jnp.asarray(rows),
                                jnp.asarray(words), jnp.asarray(vals),
                                None if f is None else jnp.asarray(f))
    td, ts = tdelta._cell_diffs(_t(plane), _t(rows), _t(words), _t(vals),
                                None if f is None else _t(f))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (td.numpy()[11:] == 0).all()        # pad lanes contribute 0


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("reduce", [True, False])
def test_adjusted_row_counts_equal(filtered, reduce):
    plane, filt, rows, words, vals = _plane_and_overlay(2, w=1001)
    f = filt if filtered else None
    want = jdelta.adjusted_row_counts(
        jnp.asarray(plane), jnp.asarray(rows), jnp.asarray(words),
        jnp.asarray(vals), None if f is None else jnp.asarray(f),
        reduce_shards=reduce)
    got = tdelta.adjusted_row_counts(_t(plane), _t(rows), _t(words),
                                     _t(vals), None if f is None else _t(f),
                                     reduce_shards=reduce)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it is the count of the plane with the cells written in
    merged = plane.copy().reshape(-1, plane.shape[-1])
    merged[rows[:11], words[:11]] = vals[:11]
    merged = merged.reshape(plane.shape)
    if f is not None:
        merged = merged & f[:, None, :]
    truth = np.bitwise_count(merged).sum(-1)
    np.testing.assert_array_equal(got.numpy(),
                                  truth.sum(0) if reduce else truth)


@pytest.mark.parametrize("slots", [(0,), (1, 3), (0, 2, 2), (3, 1, 0, 2, 1)])
def test_adjusted_selected_counts_equal(slots):
    """Repeated slots and the pow2 pad lanes that repeat the last slot."""
    plane, _, rows, words, vals = _plane_and_overlay(3, r=4, n=13, c_pad=32)
    bucket = 1 << max(0, (len(slots) - 1).bit_length())
    padded = np.array(slots + (slots[-1],) * (bucket - len(slots)),
                      np.int32)
    want = jdelta.adjusted_selected_counts(
        jnp.asarray(plane), jnp.asarray(padded), jnp.asarray(rows),
        jnp.asarray(words), jnp.asarray(vals))
    got = tdelta.adjusted_selected_counts(_t(plane), _t(padded), _t(rows),
                                          _t(words), _t(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_delta_mirror_equal():
    rng = np.random.default_rng(4)
    jm, tm = jdelta.DeltaMirror(3000), tdelta.DeltaMirror(3000)
    for step in range(4):
        cells = {(int(r), int(w)): int(v) for r, w, v in zip(
            rng.integers(0, 40, 900), rng.integers(0, 64, 900),
            rng.integers(0, 1 << 32, 900, dtype=np.uint32))}
        cells[(0, 0)] = 0xFFFFFFFF if step % 2 else 0x80000000
        assert tm.would_fit(cells) == jm.would_fit(cells)
        jm.absorb(cells)
        tm.absorb(cells)
        assert len(tm) == len(jm) and tm.bits == jm.bits
        assert tm.snapshot() == jm.snapshot()
        jo = jm.build_overlay(np.asarray, 40 * 128)
        to = tm.build_overlay("cpu", 40 * 128)
        assert (to.n, to.bits) == (jo.n, jo.bits)
        np.testing.assert_array_equal(to.rows.numpy(), jo.rows)
        np.testing.assert_array_equal(to.words.numpy(), jo.words)
        np.testing.assert_array_equal(to.vals.numpy().view(np.uint32),
                                      jo.vals)
    big = {(1000 + i, 0): 1 for i in range(2000)}
    assert tm.would_fit(big) == jm.would_fit(big) is False


def test_apply_plane_cells_resets_then_cells():
    plane, _, rows, words, vals = _plane_and_overlay(5)
    w = plane.shape[-1]
    base = _t(plane)
    reset = np.full((1, w), 0x0F0F0F0F, np.uint32)
    out = _apply_plane_cells(base, rows[:11], words[:11], vals[:11],
                             [int(rows[0])], reset)
    want = plane.reshape(-1, w).copy()
    want[int(rows[0])] = reset[0]
    want[rows[:11], words[:11]] = vals[:11]
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  want.reshape(plane.shape))
    # out of place: the base is untouched
    np.testing.assert_array_equal(base.numpy().view(np.uint32), plane)
    with pytest.raises(IndexError):
        _apply_plane_cells(base, [plane.shape[0] * plane.shape[1]], [0],
                           [1], [], np.zeros((0, w), np.uint32))


# ---------------------------------------------------------------------------
# fragment journals
# ---------------------------------------------------------------------------


def _ops(rng):
    """One op sequence: small sets (some bits already set), a clear that
    names an absent row, roaring imports both ways, a dense row (over
    32768 bits) written and cleared, a snapshot in the middle and an op
    over the journal's cell cap."""
    def pos(rows, cols):
        return (np.asarray(rows, np.uint64) * np.uint64(SW)
                + np.asarray(cols, np.uint64))
    dense_cols = rng.choice(SW, 40000, replace=False)
    over = np.arange(70000, dtype=np.uint64)
    yield "set_bits", ([0, 0, 1], [1, 40, 5])
    yield "set_bits", ([0, 0, 1, 1], [1, 41, 5, 700])
    yield "clear_bits", ([0, 2], [1, 7])
    yield "import_roaring", (jroaring.serialize(pos(
        rng.integers(0, 4, 300), rng.choice(SW, 300, replace=False))),
        False)
    yield "set_bits", (np.full(40000, 6), dense_cols)
    yield "snapshot", ()
    yield "set_bits", ([6, 6, 3], [int(dense_cols[0]), 12345, 99])
    yield "clear_bits", (np.full(500, 6), dense_cols[:500])
    yield "import_roaring", (jroaring.serialize(pos([0, 1], [41, 700])),
                             True)
    yield "set_bits", (3 + over % 3, (over // 3) * 32 + 1)  # 70000 words
    yield "set_bits", ([5], [3])
    yield "clear_bits", ([5, 6], [3, int(dense_cols[700])])


def test_changed_cells_since_equal(tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jf = JFragment(str(tmp_path / "j" / "0"), 0).open()
    tf = TFragment(str(tmp_path / "t" / "0"), 0).open()
    try:
        for name, args in _ops(rng):
            got = getattr(tf, name)(*args)
            want = getattr(jf, name)(*args)
            assert got == want, name
            assert tf.generation == jf.generation
            for g in range(tf.generation + 2):
                assert tf.changed_cells_since(g) == \
                    jf.changed_cells_since(g), (name, g)
        assert tf.changed_cells_since(0) is None      # behind the gap
        assert tf.changed_cells_since(tf.generation) == {}
        assert tf.changed_cells_since(tf.generation + 1) is None
        assert 6 in tf.dense                          # the dense row path
        np.testing.assert_array_equal(tf.positions(), jf.positions())
        for r in range(8):
            np.testing.assert_array_equal(tf.row_words(r),
                                          np.asarray(jf.row(r).words()))
            idx = np.array([0, 3, 700 >> 5, 32767])
            np.testing.assert_array_equal(
                tf.row_words(r, idx), np.asarray(jf.row(r).words())[idx])
    finally:
        tf.close()
        jf.close()


# ---------------------------------------------------------------------------
# the slice: REST imports interleaved with queries, both APIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ingest") / "data")
    _write_index(root)
    return root


def _batches():
    """(body, note) import steps over index ``i`` field ``f`` (rows 0..6
    hold bits; row 7 is empty, so not in the plane)."""
    rng = np.random.default_rng(8)
    sets = []
    for k in range(4):
        cols = rng.choice(SHARDS * SW, 300, replace=False)
        rows = rng.integers(0, 7, 300)
        sets.append((rows, cols))
        yield {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}, \
            "absorb"
        if k == 1:
            prev_r, prev_c = sets[0]
            yield {"rowIDs": prev_r[:150].tolist(),
                   "columnIDs": prev_c[:150].tolist(),
                   "clear": True}, "absorb"
    yield {"rowIDs": [7, 7, 2], "columnIDs": [5, SW + 9, 77]}, "rebuild"
    over = rng.choice(SHARDS * SW, 100_000, replace=False)
    yield {"rowIDs": rng.integers(0, 8, 100_000).tolist(),
           "columnIDs": over.tolist()}, "rebuild"
    cols = rng.choice(SHARDS * SW, 200, replace=False)
    yield {"rowIDs": rng.integers(0, 8, 200).tolist(),
           "columnIDs": cols.tolist()}, "absorb"


def test_imports_while_serving_same_json(index_dir, tmp_path, monkeypatch):
    from pilosa_tpu.api import Server as JServer
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(index_dir, jdir)
    shutil.copytree(index_dir, tdir)
    jh, japi = _jax_api(jdir, monkeypatch)
    th, tapi = _port_api(tdir)
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    planes = tapi.executor.planes
    try:
        jb, tb = "http://%s:%d" % js.address, "http://%s:%d" % ts.address
        for pql in READS:
            assert tapi.query("i", pql)["results"] == \
                japi.query("i", pql)["results"], pql
        for step, (body, note) in enumerate(_batches()):
            builds = planes.builds
            raw = json.dumps(body).encode()
            path = "/index/i/field/f/import"
            assert _post(tb, path, raw) == _post(jb, path, raw), step
            for pql in READS:
                want = japi.query("i", pql)["results"]
                assert tapi.query("i", pql)["results"] == want, (step, pql)
            moved = planes.builds - builds
            assert (moved == 0) if note == "absorb" else (moved >= 1), \
                (step, note, moved)
        assert planes.delta_stats()["absorbs"] >= 4
        assert planes.wait_compactions(60)
        status = _get(tb, "/status")
        assert status["ingest"]["importedBits"] > 0
        assert status["ingest"]["deltaCap"] == 65536
    finally:
        ts.close()
        js.close()
        planes.wait_compactions(60)
        th.close()
        jh.close()


# ---------------------------------------------------------------------------
# the plane cache's choices, on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture
def port(index_dir, tmp_path):
    root = str(tmp_path / "t")
    shutil.copytree(index_dir, root)
    holder, api = _port_api(root)
    yield holder, api
    api.executor.planes.wait_compactions(60)
    holder.close()


def _counts_oracle(field, rows):
    view = field.standard_view()
    return [sum(int(np.bitwise_count(view.fragment(s).row_words(r)).sum())
                for s in view.fragments) for r in rows]


def test_reader_keeps_pre_fold_answer(port):
    """A fold makes a NEW base: a reader still holding the overlay
    PlaneSet counts base+delta exactly once."""
    holder, api = port
    api.query("i", COUNTS)
    f = holder.index("i").field("f")
    api.import_bits("i", "f", row_ids=[1, 2, 2],
                    col_ids=[3, SW + 64, 2 * SW + 5])
    planes = api.executor.planes
    shards = tuple(range(SHARDS))
    old = planes.field_plane_nowait("i", f, "standard", shards)
    assert old.delta is not None and old.delta.n == 3
    fused = api.executor.fused
    before = fused.run_rowcounts_delta(old.plane, old.delta).clone()
    base = old.plane.clone()
    clean = planes.field_plane("i", f, "standard", shards)   # folds
    assert clean.delta is None and clean.plane is not old.plane
    assert torch.equal(old.plane, base)
    assert torch.equal(fused.run_rowcounts_delta(old.plane, old.delta),
                       before)
    assert torch.equal(tk.row_counts(clean.plane).sum(0, dtype=torch.int32),
                       before)
    assert planes.delta_stats()["compactions"] == 1
    assert [int(v) for v in before[:8]] == _counts_oracle(f, range(8))


def test_compaction_folds_without_rebuild(port):
    holder, api = port
    planes = api.executor.planes
    planes.delta_cells = 64
    api.query("i", COUNTS)
    f = holder.index("i").field("f")
    for k in range(6):
        api.import_bits("i", "f", row_ids=[k % 7] * 12,
                        col_ids=[(k * 12 + j) * 64 + SW for j in range(12)])
        assert api.query("i", COUNTS)["results"] == \
            _counts_oracle(f, range(8))
    assert planes.wait_compactions(60)
    d = planes.delta_stats()
    assert d["compactions"] >= 1 and d["absorbs"] >= 3
    assert planes.builds == 1
    assert api.query("i", COUNTS)["results"] == _counts_oracle(f, range(8))
    assert api.query("i", "TopN(f, n=3)")["results"] == \
        [[{"id": r, "count": c} for r, c in sorted(
            zip(range(8), _counts_oracle(f, range(8))),
            key=lambda rc: -rc[1])[:3]]]


def test_row_entry_refreshes_in_place(port):
    """A stale single-row entry takes the journal, not a re-expansion."""
    holder, api = port
    planes = api.executor.planes
    want = api.query("i", "Count(Row(f=3))")["results"][0]
    api.query("i", f"Set({SW + 3}, f=3)Clear(7, f=3)")
    f = holder.index("i").field("f")
    n = planes.incremental_applied
    got = api.query("i", "Count(Row(f=3))")["results"][0]
    assert planes.incremental_applied == n + 1
    assert got == _counts_oracle(f, [3])[0]
    assert abs(got - want) <= 2


def test_recreated_field_rebuilds(port):
    """Generations ahead of the fragments (the field was dropped and made
    anew) never take the journal."""
    holder, api = port
    api.query("i", f"Set(1, h=1)Set(2, h=1)Set({SW}, h=1)")
    api.query("i", "TopN(h)")
    idx = holder.index("i")
    old = idx.fields.pop("h")
    old.close()
    shutil.rmtree(old.path)
    idx.create_field("h")
    api.query("i", "Set(5, h=2)")
    builds = api.executor.planes.builds
    assert api.query("i", "TopN(h)")["results"] == [[{"id": 2, "count": 1}]]
    assert api.executor.planes.builds == builds + 1


def test_import_errors_and_roaring(port):
    holder, api = port
    # row keys on an unkeyed field: the reference's 400 and message
    with pytest.raises(ApiError, match="^field 'f' is not keyed$") as e:
        api.import_bits("i", "f", row_keys=["a"], col_ids=[1])
    assert e.value.status == 400
    for kw in ({"row_ids": [1], "col_ids": [1], "timestamps": ["x"]},
               {"row_ids": [1, 2], "col_ids": [1]},
               {"col_ids": [1]}):
        with pytest.raises(ApiError) as e:
            api.import_bits("i", "f", **kw)
        assert e.value.status == 400
    # an op id applies every delivery on a single node, as in the
    # reference (no cluster: no duplicate check)
    f0 = holder.index("i").field("f")
    was = _counts_oracle(f0, [7])
    assert api.import_bits("i", "f", row_ids=[7], col_ids=[2 * SW + 9],
                           op_id="x") == 1
    assert api.import_bits("i", "f", row_ids=[7], col_ids=[2 * SW + 9],
                           op_id="x") == 0
    assert api.import_bits("i", "f", row_ids=[7], col_ids=[2 * SW + 9],
                           clear=True, op_id="y") == 1
    assert _counts_oracle(f0, [7]) == was
    with pytest.raises(ApiError) as e:
        api.import_bits("i", "nope", row_ids=[1], col_ids=[1])
    assert e.value.status == 404
    api.query("i", COUNTS)
    f = holder.index("i").field("f")
    blob = troaring.serialize(np.array([7 * SW + 11, 7 * SW + 12],
                                       np.uint64))     # row 7 was empty
    before = _counts_oracle(f, range(8))
    assert api.import_roaring("i", "f", 1, blob) == 2
    assert api.import_roaring("i", "f", 1, blob) == 0
    assert api.query("i", COUNTS)["results"] == _counts_oracle(f, range(8))
    assert api.import_roaring("i", "f", 1, blob, clear=True) == 2
    assert api.query("i", COUNTS)["results"] == before
    with pytest.raises(ApiError):
        api.import_roaring("i", "f", 1, b"junk")


def test_rest_import_routes(tmp_path):
    holder, api = _port_api(str(tmp_path))
    server = TServer(api, "127.0.0.1", 0).start()
    try:
        base = "http://%s:%d" % server.address
        _post(base, "/index/x", b"{}")
        _post(base, "/index/x/field/f", b"{}")
        body = json.dumps({"rowIDs": [1, 1, 2],
                           "columnIDs": [3, 4, SW + 1]}).encode()
        assert _post(base, "/index/x/field/f/import", body) == \
            {"changed": 3}
        assert _post(base, "/index/x/query",
                     b"Count(Row(f=1))Count(Row(f=2))") == \
            {"results": [2, 1]}
        clear = json.dumps({"rowIDs": [1], "columnIDs": [3]}).encode()
        assert _post(base, "/index/x/field/f/import?clear", clear) == \
            {"changed": 1}
        blob = troaring.serialize(np.array([1 * SW + 9], np.uint64))
        assert _post(base, "/index/x/field/f/import-roaring/0", blob) == \
            {"changed": 1}
        assert _post(base, "/index/x/query", b"Count(Row(f=1))") == \
            {"results": [2]}
        status = _get(base, "/status")["ingest"]
        assert status["importedBits"] == 5
        assert {"deltaCells", "deltaFillRatio", "absorbs", "compactions",
                "pendingCompactions"} <= set(status)
    finally:
        server.close()
        holder.close()


def test_concurrent_imports_and_counts(port):
    """Writer and reader threads over one executor (more threads than
    cores, a short switch interval): no errors, no acked bit lost, and
    the quiesced answer equals the fragment oracle."""
    import os
    import sys
    holder, api = port
    planes = api.executor.planes
    planes.delta_cells = 256
    f = holder.index("i").field("f")
    api.query("i", COUNTS)
    floor = [_counts_oracle(f, [5])[0]]
    lock = threading.Lock()
    errors = []
    stop = threading.Event()

    def writer(wid):
        rng = np.random.default_rng(wid)
        for _ in range(10):
            cols = rng.choice(SHARDS * SW, 8, replace=False)
            try:
                n = api.import_bits("i", "f", row_ids=[5] * 8,
                                    col_ids=cols.tolist())
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            with lock:
                floor[0] += n

    def reader():
        while not stop.is_set():
            with lock:
                lo = floor[0]
            try:
                got = api.query("i", "Count(Row(f=5))Count(Row(f=1))")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            if got["results"][0] < lo:
                errors.append(f"lost writes: {got} < {lo}")
                return

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writers = [threading.Thread(target=writer, args=(w,))
                   for w in range(os.cpu_count() or 4)]
        readers = [threading.Thread(target=reader)
                   for _ in range(os.cpu_count() or 4)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in writers + readers)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert planes.wait_compactions(60)
    assert api.query("i", "Count(Row(f=5))")["results"] == \
        _counts_oracle(f, [5])
