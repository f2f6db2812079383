"""The port's plane build pipeline and ``.dense`` sidecars against
``pilosa_tpu``: the builder-pool build bit for bit against the reference's
plain ``_build_plane`` over the same data, a write racing a background
build, warm restarts, compaction re-stamping, per-fragment invalidation,
damaged images (truncated, a flipped byte inside the image, bad magic,
a stale stamp) falling back cold, sidecars off, the cases of
``tests/test_planes_pipeline.py`` in the port's form; then sidecars
written by either package read warm by the other with equal bytes, and
paged Counts over warm images."""

import glob
import os
import threading

import numpy as np
import pytest

from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20


def _mixed_bits(rng, n_shards: int):
    """(rows, cols) making every container kind in every shard: runs
    (row 1), arrays (row 2), a bitmap (row 3), and a high row 41."""
    rows, cols = [], []
    for s in range(n_shards):
        base = s * SW
        r = np.arange(5000, 14000)
        rows.append(np.full(len(r), 1)), cols.append(base + r)
        r = np.sort(rng.choice(SW, 700, replace=False))
        rows.append(np.full(len(r), 2)), cols.append(base + r)
        r = np.sort(rng.choice(65536, 9000, replace=False)) + 131072
        rows.append(np.full(len(r), 3)), cols.append(base + r)
        rows.append(np.array([41])), cols.append(np.array([base + 7]))
    return (np.concatenate(rows).astype(np.uint64),
            np.concatenate(cols).astype(np.uint64))


def _seed(holder, rng, n_shards: int) -> None:
    field = holder.index("i").field("f")
    rows, cols = _mixed_bits(rng, n_shards)
    field.import_bits(rows, cols)


def _open(H, root: str):
    holder = H(root).open()
    if holder.index("i") is None:
        holder.create_index("i").create_field("f")
    return holder


@pytest.fixture
def both(tmp_path, monkeypatch):
    """A JAX and a port holder over their own copies of index ``i``."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    jh = _open(JHolder, str(tmp_path / "j"))
    th = _open(THolder, str(tmp_path / "t"))
    yield jh, th
    for h in (jh, th):
        try:
            h.close()
        except Exception:  # noqa: BLE001 — closed by the test already
            pass


def _sidecars(root: str) -> list[str]:
    return sorted(glob.glob(os.path.join(
        root, "i", "f", "views", "standard", "fragments", "*.dense")))


def _words(ps) -> np.ndarray:
    return ps.plane.numpy().view(np.uint32)


def _oracle(jh):
    """The reference's plain whole-view build (``Fragment.plane_rows``)."""
    field = jh.index("i").field("f")
    shards = tuple(jh.index("i").available_shards())
    return JExecutor(jh).planes._build_plane(field, "standard", shards)


def _port_build(th, writes: bool = True, **kw):
    ex = TExecutor(th, device="cpu", **kw)
    if writes:
        ex.planes.SYNC_BUILD_MAX = 0  # a build past it writes images
    field = th.index("i").field("f")
    shards = tuple(th.index("i").available_shards())
    return ex, ex.planes._build_plane(field, "standard", shards)


def _plain(results) -> list:
    """Results of either package as plain values (TopN pairs, a row's
    columns, a count)."""
    out = []
    for r in results:
        if hasattr(r, "pairs"):
            out.append([(p.id, p.count) for p in r.pairs])
        elif hasattr(r, "columns"):
            out.append(np.asarray(r.columns).tolist())
        else:
            out.append(r)
    return out


def _assert_equal(ps, oracle) -> None:
    np.testing.assert_array_equal(_words(ps), np.asarray(oracle.plane))
    np.testing.assert_array_equal(ps.row_ids, oracle.row_ids)
    assert ps.slot_of == oracle.slot_of


# -- the builder pool against the reference's plain build --------------------


class TestParallelExpansionOracle:
    @pytest.mark.parametrize("seed", [3, 11, 29])
    def test_pool_build_bit_exact(self, both, seed):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(seed), 3)
        ex, ps = _port_build(th)
        _assert_equal(ps, _oracle(jh))
        assert ex.planes.warm_misses == 3 and ex.planes.warm_hits == 0
        assert len(_sidecars(th.path)) == 3
        ex.close()

    @pytest.mark.parametrize("workers", [1, 3])
    def test_chunked_double_buffer_bit_exact(self, both, workers):
        """One shard per chunk (the staging buffers alternate) and fewer
        workers than fragments."""
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(5), 3)
        ex = TExecutor(th, device="cpu")
        ex.planes.BUILD_CHUNK_BYTES = 1
        ex.planes.BUILD_WORKERS = workers
        field = th.index("i").field("f")
        ps = ex.planes._build_plane(field, "standard", (0, 1, 2))
        _assert_equal(ps, _oracle(jh))
        ex.close()

    def test_overlay_rows_beat_stale_snapshot(self, both):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(23), 2)
            for frag in h.index("i").field("f").standard_view() \
                    .fragments.values():
                frag.snapshot()
            h.index("i").field("f").import_bits(
                np.array([2, 2], np.uint64),
                np.array([123, SW + 9], np.uint64))
        ex, ps = _port_build(th)
        _assert_equal(ps, _oracle(jh))
        ex.close()

    def test_failed_expansion_raises(self, both, monkeypatch):
        """The first failure of an expansion task re-raises: a build never
        ships a half-expanded chunk."""
        _, th = both
        _seed(th, np.random.default_rng(2), 3)
        frag = th.index("i").field("f").standard_view().fragment(1)

        def boom(*a, **k):
            raise OSError("disk gone")

        monkeypatch.setattr(frag, "expand_rows_into", boom)
        ex = TExecutor(th, device="cpu")
        with pytest.raises(OSError, match="disk gone"):
            ex.planes._build_plane(th.index("i").field("f"), "standard",
                                   (0, 1, 2))
        ex.close()


class TestMidBuildWrite:
    def test_mid_build_write_leaves_entry_stale(self, both):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(31), 2)
        ex = TExecutor(th, device="cpu")
        ex.planes.SYNC_BUILD_MAX = 0  # every plane builds in the background
        gate = threading.Event()
        real = ex.planes._build_plane

        def gated(*a, **k):
            gate.wait(120)
            return real(*a, **k)

        ex.planes._build_plane = gated
        try:
            jex = JExecutor(jh, kernel_tier="pallas")
            want = _plain(jex.execute("i", "TopN(f, n=4)"))
            assert _plain(ex.execute("i", "TopN(f, n=4)")) == want
            assert ex.planes._building
            new_col = 2 * SW - 3
            ex.execute("i", f"Set({new_col}, f=2)")
            jex.execute("i", f"Set({new_col}, f=2)")
            gate.set()
            ex.planes.wait_builds()
            field = th.index("i").field("f")
            shards = tuple(th.index("i").available_shards())
            hit = ex.planes._entries.get(("plane", "i", "f", "standard",
                                          shards))
            assert hit is not None
            assert hit[0] != ex.planes._gens(field, "standard", shards)
            assert ex.execute("i", "Count(Row(f=2))") \
                == jex.execute("i", "Count(Row(f=2))")
            assert _plain(ex.execute("i", "TopN(f, n=4)")) \
                == _plain(jex.execute("i", "TopN(f, n=4)"))
            jex.translate.close()
        finally:
            gate.set()
            ex.close()


# -- the warm cache ------------------------------------------------------------


class TestWarmSidecarCache:
    def test_restart_round_trip_oracle_exact(self, both):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(47), 3)
        oracle = _oracle(jh)
        ex, cold = _port_build(th)
        assert ex.planes.warm_hits == 0 and ex.planes.warm_misses == 3
        assert ex.planes.stats()["sidecarBytesWritten"] > 0
        want = {q: _plain(ex.execute("i", q)) for q in
                ("TopN(f)", "Count(Row(f=1))", "Row(f=3)")}
        ex.close()
        th.close()

        th2 = THolder(th.path).open()
        ex2, warm = _port_build(th2)
        assert ex2.planes.warm_hits == 3 and ex2.planes.warm_misses == 0
        _assert_equal(warm, oracle)
        np.testing.assert_array_equal(_words(cold), _words(warm))
        for q, w in want.items():
            assert _plain(ex2.execute("i", q)) == w
        ex2.close()
        th2.close()

    def test_compaction_restamps_still_valid_sidecar(self, both):
        _, th = both
        _seed(th, np.random.default_rng(7), 2)
        ex, _ = _port_build(th)
        ex.close()
        stamps = [open(p, "rb").read(48) for p in _sidecars(th.path)]
        th.close()  # compacts every written fragment
        assert [open(p, "rb").read(48) for p in _sidecars(th.path)] \
            != stamps
        th2 = THolder(th.path).open()
        ex2, _ = _port_build(th2)
        assert ex2.planes.warm_hits == 2
        ex2.close()
        th2.close()

    def test_write_invalidates_one_fragment(self, both):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(8), 2)
        ex, _ = _port_build(th)
        ex.close()
        for h in both:
            h.index("i").field("f").import_bits(np.array([1], np.uint64),
                                                np.array([99], np.uint64))
        ex2, got = _port_build(th)
        _assert_equal(got, _oracle(jh))
        assert ex2.planes.warm_misses == 1 and ex2.planes.warm_hits == 1
        # the cold one rewrote its image: the next build is all warm
        ex3, again = _port_build(th)
        assert ex3.planes.warm_hits == 2
        np.testing.assert_array_equal(_words(again), _words(got))
        ex2.close()
        ex3.close()

    @pytest.mark.parametrize("damage", ["flip", "truncate", "garbage",
                                        "magic", "stale"])
    def test_damaged_sidecar_falls_back_cold(self, both, damage):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(9), 2)
        ex, _ = _port_build(th)
        ex.close()
        for p in _sidecars(th.path):
            with open(p, "r+b") as f:
                if damage == "flip":      # inside the image: the crc
                    f.seek(70)
                    b = f.read(1)
                    f.seek(70)
                    f.write(bytes([b[0] ^ 0x10]))
                elif damage == "truncate":
                    f.truncate(30)
                elif damage == "garbage":
                    f.truncate(0)
                    f.write(b"garbage")
                elif damage == "magic":
                    f.write(b"XDN1")
                else:                     # the op-log size moved on
                    f.seek(24)
                    f.write((12345).to_bytes(8, "little"))
        ex2, got = _port_build(th, writes=False)
        _assert_equal(got, _oracle(jh))
        assert ex2.planes.warm_hits == 0 and ex2.planes.warm_misses == 2
        ex2.close()

    def test_sidecars_off_writes_nothing(self, both):
        _, th = both
        _seed(th, np.random.default_rng(10), 2)
        ex, _ = _port_build(th, plane_sidecars=False)
        assert _sidecars(th.path) == []
        assert ex.planes.warm_hits == ex.planes.warm_misses == 0
        ex.close()

    def test_small_inline_build_writes_nothing(self, both):
        """A plane under ``SYNC_BUILD_MAX`` builds from the snapshots and
        writes no image, as the reference's inline builds."""
        _, th = both
        _seed(th, np.random.default_rng(12), 2)
        ex, _ = _port_build(th, writes=False)
        assert _sidecars(th.path) == []
        ex.close()

    def test_warm_serving_through_executor(self, both):
        jh, th = both
        for h in both:
            _seed(h, np.random.default_rng(13), 3)
        jex = JExecutor(jh, kernel_tier="pallas")
        want = _plain(jex.execute("i", "TopN(f)"))
        jex.translate.close()
        ex = TExecutor(th, device="cpu")
        ex.planes.SYNC_BUILD_MAX = 0
        assert _plain(ex.execute("i", "TopN(f)")) == want
        ex.planes.wait_builds()
        assert _plain(ex.execute("i", "TopN(f)")) == want
        ex.close()
        th.close()
        th2 = THolder(th.path).open()
        ex2 = TExecutor(th2, device="cpu")
        ex2.planes.SYNC_BUILD_MAX = 0
        assert _plain(ex2.execute("i", "TopN(f)")) == want   # streamed
        ex2.planes.wait_builds()
        assert _plain(ex2.execute("i", "TopN(f)")) == want   # resident
        assert ex2.planes.warm_hits == 3
        ex2.close()
        th2.close()


# -- across packages -----------------------------------------------------------


def test_sidecars_cross_packages_equal_bytes(tmp_path, monkeypatch):
    """The reference's images read warm by the port; the port's, written
    over the same files, byte-equal to them and read warm by the
    reference."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    root = str(tmp_path / "d")
    jh = _open(JHolder, root)
    _seed(jh, np.random.default_rng(17), 3)
    field = jh.index("i").field("f")
    jex = JExecutor(jh)
    oracle = jex.planes._build_plane(field, "standard", (0, 1, 2))
    jex.planes._build_plane_chunked(field, "standard", (0, 1, 2))
    jh.close()  # compacts; the images are re-stamped
    jbytes = [open(p, "rb").read() for p in _sidecars(root)]
    assert len(jbytes) == 3

    th = THolder(root).open()
    ex, warm = _port_build(th)
    assert ex.planes.warm_hits == 3 and ex.planes.warm_misses == 0
    _assert_equal(warm, oracle)
    for p in _sidecars(root):
        os.unlink(p)
    ex2, cold = _port_build(th)
    assert ex2.planes.warm_misses == 3
    assert [open(p, "rb").read() for p in _sidecars(root)] == jbytes
    np.testing.assert_array_equal(_words(cold), _words(warm))
    ex.close()
    ex2.close()
    th.close()

    jh2 = JHolder(root).open()
    jex2 = JExecutor(jh2)
    again = jex2.planes._build_plane_chunked(
        jh2.index("i").field("f"), "standard", (0, 1, 2))
    assert jex2.planes.warm_hits == 3
    np.testing.assert_array_equal(np.asarray(again.plane),
                                  np.asarray(oracle.plane))
    jh2.close()


def test_port_images_read_warm_by_reference(tmp_path):
    """An image the port wrote first (on data it wrote) is a warm hit for
    the reference on the same directory."""
    root = str(tmp_path / "d")
    th = _open(THolder, root)
    _seed(th, np.random.default_rng(19), 2)
    ex, ps = _port_build(th)
    ex.close()
    tbytes = [open(p, "rb").read() for p in _sidecars(root)]
    jh = JHolder(root).open()
    jex = JExecutor(jh)
    got = jex.planes._build_plane_chunked(jh.index("i").field("f"),
                                          "standard", (0, 1))
    assert jex.planes.warm_hits == 2 and jex.planes.warm_misses == 0
    np.testing.assert_array_equal(np.asarray(got.plane), _words(ps))
    # a reference cold build over the same state writes the same bytes
    for p in _sidecars(root):
        os.unlink(p)
    jex.planes._build_plane_chunked(jh.index("i").field("f"), "standard",
                                    (0, 1))
    assert [open(p, "rb").read() for p in _sidecars(root)] == tbytes
    jh.close()
    th.close()


PAGED = {"plane_budget": 1200 * 1024, "plane_page_bytes": 1 << 20}


@pytest.mark.parametrize("config", ["off", "default"])
def test_paged_counts_over_warm_images(tmp_path, monkeypatch, config):
    """Page-ins write images and read them warm once the pages are evicted;
    the Counts equal the reference's throughout."""
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    cfg = ({"count_batch_window": "off", "tree_fusion": False}
           if config == "off" else {})
    jh = _open(JHolder, str(tmp_path / "j"))
    th = _open(THolder, str(tmp_path / "t"))
    jex = JExecutor(jh, kernel_tier="pallas", **cfg, **PAGED)
    tex = TExecutor(th, device="cpu", **cfg, **PAGED)
    try:
        for h in (jh, th):
            _seed(h, np.random.default_rng(21), 3)
        q = "".join(f"Count(Row(f={r}))" for r in (1, 2, 3, 41))
        want = jex.execute("i", q)
        assert tex.execute("i", q) == want               # cold page-ins
        st = tex.tenancy_status()
        assert st["pageIns"] >= 2 and tex.planes.builds == 0
        assert tex.planes.warm_misses == 3 and tex.planes.warm_hits == 0
        assert len(_sidecars(th.path)) == 3
        tex.planes.evict_unpinned(reason="test")
        assert tex.execute("i", q) == want               # warm page-ins
        assert tex.planes.warm_hits == 3
        # a write: that fragment's page-in goes cold again, exactly
        for ex in (jex, tex):
            ex.execute("i", f"Set({SW + 5}, f=2)")
        tex.planes.evict_unpinned(reason="test")
        want = jex.execute("i", q)
        assert tex.execute("i", q) == want
        assert tex.planes.warm_hits == 5 and tex.planes.warm_misses == 4
    finally:
        jex.translate.close()
        tex.close()
        jh.close()
        th.close()
