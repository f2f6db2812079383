"""The port's storage layer against ``pilosa_tpu.store``: byte-identical
roaring writers, and data directories that each package writes and the
other opens to the same bits."""

import json
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu.store.fragment import Fragment as JFragment
from pilosa_tpu_torch.exec.planes import plane_from_numpy
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.store.fragment import Fragment as TFragment
from pilosa_tpu_torch.store.oplog import OpLog

SW = 1 << 20


def _positions(rng) -> np.ndarray:
    """Bit positions that make every container kind: sparse arrays, a
    dense bitmap, long runs, across several rows."""
    sparse = rng.choice(3 * SW, 3000, replace=False).astype(np.uint64)
    dense = (np.uint64(4 * SW)
             + rng.choice(65536, 30000, replace=False).astype(np.uint64))
    runs = np.arange(5 * SW + 100, 5 * SW + 20000, dtype=np.uint64)
    return np.concatenate([sparse, dense, runs])


class TestRoaring:
    def test_serialize_identical(self, rng):
        pos = _positions(rng)
        assert troaring.serialize(pos) == jroaring.serialize(pos)
        assert troaring.serialize(np.empty(0, np.uint64)) \
            == jroaring.serialize(np.empty(0, np.uint64))

    @pytest.mark.parametrize("rows", [1, 3])
    def test_serialize_dense_identical(self, rng, rows):
        words = rng.integers(0, 1 << 32, size=(rows, 32768), dtype=np.uint32)
        words[0, 4096:6144] = 0  # one empty container
        ids = np.array([7, 2, 40][:rows], np.uint64)
        assert troaring.serialize_dense(words) \
            == jroaring.serialize_dense(words)
        assert troaring.serialize_dense(words, ids) \
            == jroaring.serialize_dense(words, ids)

    def test_deserialize_both_ways(self, rng):
        pos = np.unique(_positions(rng))
        np.testing.assert_array_equal(
            troaring.deserialize(jroaring.serialize(pos)), pos)
        np.testing.assert_array_equal(
            jroaring.deserialize(troaring.serialize(pos)), pos)

    def test_directory_row_words(self, rng):
        pos = np.unique(_positions(rng))
        blob = jroaring.serialize(pos)
        jd, td = jroaring.Directory(blob), troaring.Directory(blob)
        np.testing.assert_array_equal(td.row_ids(), jd.row_ids())
        for row in td.row_ids().tolist():
            a = np.zeros(32768, np.uint32)
            b = np.zeros(32768, np.uint32)
            jd.row_words(row, a)
            td.row_words(row, b)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(td.expand_row(row),
                                          jd.expand_row(row))


class TestOpLog:
    def test_torn_tail_truncates(self, tmp_path, rng):
        log = OpLog(str(tmp_path / "x.oplog"))
        big = np.unique(rng.integers(0, SW, 5000).astype(np.uint64))
        log.append(1, 0, np.array([1, 2, 3], np.uint64))
        log.append(1, 0, big)
        log.append(3, 7, None)
        log.close()
        with open(tmp_path / "x.oplog", "ab") as f:
            f.write(b"\x01\x02\x03")  # torn record
        got = list(log.replay())
        assert [(op, aux) for op, aux, _ in got] == [(1, 0), (1, 0), (3, 7)]
        np.testing.assert_array_equal(got[1][2], big)
        assert list(log.replay())[-1][:2] == (3, 7)  # file was truncated


def _frag_positions(root, index, field, shard, cls):
    path = os.path.join(root, index, field, "views", "standard",
                        "fragments", str(shard))
    frag = cls(path, shard).open()
    try:
        return frag.positions()
    finally:
        frag._oplog.close()


class TestHolderRoundTrip:
    def _write(self, holder, rng):
        idx = holder.create_index("i")
        f = idx.create_field("f")
        cols = rng.choice(3 * SW, 4000, replace=False).astype(np.uint64)
        rows = rng.integers(0, 5, len(cols)).astype(np.uint64)
        f.import_bits(rows, cols)
        idx.note_columns(cols)
        f.set_bit(9, 2 * SW + 5)
        f.clear_bit(int(rows[0]), int(cols[0]))
        return cols

    @pytest.mark.parametrize("close_first", [True, False])
    def test_jax_writes_port_reads(self, tmp_path, rng, close_first):
        jh = JHolder(str(tmp_path)).open()
        self._write(jh, rng)
        if close_first:
            jh.close()  # compacts into framed snapshots
        th = THolder(str(tmp_path)).open()
        other = JHolder(str(tmp_path)).open()
        assert th.schema() == other.schema()
        other.close()
        for field in ("f", "_exists"):
            for shard in range(3):
                np.testing.assert_array_equal(
                    _frag_positions(str(tmp_path), "i", field, shard,
                                    TFragment),
                    _frag_positions(str(tmp_path), "i", field, shard,
                                    JFragment))
        th.close()
        if not close_first:
            jh.close()

    @pytest.mark.parametrize("close_first", [True, False])
    def test_port_writes_jax_reads(self, tmp_path, rng, close_first):
        th = THolder(str(tmp_path)).open()
        self._write(th, rng)
        if close_first:
            th.close()
        jh = JHolder(str(tmp_path)).open()
        try:
            other = THolder(str(tmp_path)).open()
            assert jh.schema() == other.schema()
            other.close()
            f = jh.index("i").field("f")
            for shard in range(3):
                want = _frag_positions(str(tmp_path), "i", "f", shard,
                                       TFragment)
                np.testing.assert_array_equal(
                    f.standard_view().fragment(shard).positions(), want)
        finally:
            jh.close()
            if not close_first:
                th.close()

    def test_meta_files_identical(self, tmp_path):
        for name, cls in (("j", JHolder), ("t", THolder)):
            h = cls(str(tmp_path / name)).open()
            h.create_index("i", created_at=5.0).create_field("f")
            h.close()
        assert (tmp_path / "j/i/.meta").read_bytes() \
            == (tmp_path / "t/i/.meta").read_bytes()
        for rel in ("i/f/.meta", "i/_exists/.meta"):
            # the same keys in the same order; only the creation time
            # differs between the two runs
            jf = json.loads((tmp_path / "j" / rel).read_text())
            tf = json.loads((tmp_path / "t" / rel).read_text())
            jf.pop("created_at"), tf.pop("created_at")
            assert list(jf) == list(tf) and jf == tf

    def test_legacy_dense_snapshot(self, tmp_path, rng):
        """The bench's writer: raw serialize_dense blobs as snapshots."""
        words = rng.integers(0, 1 << 32, size=(4, 32768), dtype=np.uint32)
        path = tmp_path / "0"
        path.write_bytes(jroaring.serialize_dense(words))
        frag = TFragment(str(path), 0).open()
        out = np.zeros((4, 32768), np.uint32)
        frag.expand_rows_into([0, 1, 2, 3], out)
        np.testing.assert_array_equal(out, words)
        assert sorted(frag.row_ids_array().tolist()) == [0, 1, 2, 3]


def test_plane_from_numpy_bit_exact(rng):
    plane = rng.integers(0, 1 << 32, size=(2, 3, 64), dtype=np.uint32)
    plane[0, 0, :2] = [0x80000000, 0xFFFFFFFF]
    t = plane_from_numpy(plane, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == plane.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), plane)


def test_map_pool_demotes_to_heap(tmp_path, rng, monkeypatch):
    """Past the pool's cap of live snapshot maps the oldest fragments read
    from heap copies (their descriptors released): the same bits, the
    same answers as the JAX package, and no more live maps than the cap."""
    from pilosa_tpu_torch.store import syswrap
    root = str(tmp_path)
    jh = JHolder(root).open()
    idx = jh.create_index("i")
    idx.create_field("f")
    cols = rng.choice(6 * SW, 5000, replace=False).astype(np.uint64)
    idx.field("f").import_bits(rng.integers(0, 5, 5000).astype(np.uint64),
                               cols)
    jh.close()                      # six snapshots
    pool = syswrap.MapPool(max_maps=2)
    monkeypatch.setattr(syswrap, "GLOBAL", pool)
    th, jh = THolder(root).open(), JHolder(root).open()
    try:
        assert pool.live == 2
        frags = th.index("i").field("f").standard_view().fragments
        heap = [f for f in frags.values() if f._snap_mm is None]
        assert len(heap) == 4 and all(f._snap_dir is not None for f in heap)
        jfrags = jh.index("i").field("f").standard_view().fragments
        for s, frag in frags.items():
            np.testing.assert_array_equal(frag.positions(),
                                          jfrags[s].positions())
    finally:
        th.close()
        jh.close()
    assert pool.live == 0
