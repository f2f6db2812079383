"""TopN on fields past the plane budget, in the port against the JAX package.

One data directory, written by ``pilosa_tpu`` (index ``i`` over four
shards: a set field ``f`` of 63 rows with array, bitmap and run
containers, a filter field ``g``, a keyed field ``k``), answers through
the JAX executor (Pallas kernels in interpret mode) and the port's on the
CPU, in the "off" configuration and the default one.  Each TopN
representation is forced by the budget:

- ``dense``: the default budget (the plane is resident);
- ``host``: below the plane's bytes, unfiltered (host row cardinalities);
- ``sparse``: below the plane's bytes, above the CSR residency's;
- ``streamed``: below both (row blocks through the kernels);
- ``building``: ``SYNC_BUILD_MAX`` lowered on both caches, so the first
  TopN streams while the plane builds in the background, and the next
  reads the plane.

The JSON must be equal, errors included; the port's counters must show the
path.  Also held to the reference: ``Directory.row_cards``,
``Fragment.row_cardinalities`` and ``cardinality`` (snapshot, array,
bitmap and run containers, after writes), ``serialize`` and
``deserialize`` (and the numpy writer), the CSR arrays of the sparse build,
and :mod:`pilosa_tpu_torch.engine.sparse` against
``pilosa_tpu.engine.sparse`` on the same arrays with tie-heavy counts.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.engine import sparse as jsparse
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.planes import merge_row_cards as jmerge_row_cards
from pilosa_tpu.exec.result import result_to_json as jjson
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.engine import sparse as tsparse
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as tjson
from pilosa_tpu_torch.exec.executor import _Ctx
from pilosa_tpu_torch.exec.planes import merge_row_cards
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
SHARDS = 4
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}
PLANE = SHARDS * 64 * (SW // 8)     # f: rows 0-62 pad to 64


def _write(root: str) -> None:
    """Index ``i`` through ``pilosa_tpu``'s write path."""
    rng = np.random.default_rng(7)
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("k", JFO(keys=True))
    api = JAPI(h, JExecutor(h, plane_paging=False))
    n = 6000
    cols = (rng.integers(0, SHARDS, n) * SW
            + rng.integers(0, 5000, n)).astype(np.uint64)
    # 60 rows of ~100 bits: many rows share each count
    api.import_bits("i", "f", row_ids=rng.integers(0, 60, n).tolist(),
                    col_ids=cols.tolist())
    # a bitmap container (row 61: > 4096 bits in one 65536-bit block)
    bcols = rng.choice(65536, 6000, replace=False) + SW
    api.import_bits("i", "f", row_ids=[61] * len(bcols),
                    col_ids=bcols.tolist())
    # a run container (row 62: consecutive columns)
    api.import_bits("i", "f", row_ids=[62] * 300,
                    col_ids=list(range(2 * SW + 100, 2 * SW + 400)))
    api.import_bits("i", "g", row_ids=[0] * (n // 2),
                    col_ids=cols[::2].tolist())
    api.import_bits("i", "g", row_ids=[1] * 3, col_ids=cols[:3].tolist())
    for i, key in enumerate(("alpha", "beta", "gamma", "delta")):
        kcols = cols[i * 700:(i + 1) * 700 - i * 150].tolist()
        api.import_bits("i", "k", row_keys=[key] * len(kcols),
                        col_ids=kcols)
    api.executor.translate.close()
    h.close()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("budget"))
    _write(root)
    return root


@pytest.fixture
def copy_dir(data_dir, tmp_path):
    dst = str(tmp_path / "d")
    shutil.copytree(data_dir, dst)
    return dst


def _jax(root, monkeypatch, config, **kw):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    return holder, JExecutor(holder, kernel_tier="pallas", **CONFIGS[config],
                             **kw)


def _port(root, config, **kw):
    holder = THolder(root).open()
    return holder, TExecutor(holder, device="cpu", **CONFIGS[config], **kw)


def _answer(ex, to_json, pql: str):
    try:
        return json.loads(json.dumps([to_json(r) for r in
                                      ex.execute("i", pql)]))
    except Exception as e:  # noqa: BLE001 — compared between packages
        return ["error", str(e)]


# -- store: row cardinalities and the vectorized codec ----------------------


def _frags(holder, field="f"):
    view = holder.index("i").field(field).view("standard")
    return [view.fragment(s) for s in range(SHARDS)]


def test_row_cards_and_cardinalities_equal(copy_dir):
    jh = JHolder(copy_dir).open()
    th = THolder(copy_dir).open()
    for jf, tf in zip(_frags(jh), _frags(th)):
        ids, cards = tf.row_cardinalities()
        jids, jcards = jf.row_cardinalities()
        assert np.array_equal(ids, jids) and np.array_equal(cards, jcards)
        assert tf.cardinality() == jf.cardinality()
        if tf._snap_dir is not None:
            a, b = tf._snap_dir.row_cards()
            c, d = jf._snap_dir.row_cards()
            assert np.array_equal(a, c) and np.array_equal(b, d)
    # writes: bits of snapshot rows, a new row, a run row cleared whole
    japi = JAPI(jh, JExecutor(jh, plane_paging=False))
    tapi = TAPI(th, TExecutor(th, device="cpu"))
    for api in (japi, tapi):
        api.import_bits("i", "f", row_ids=[3, 3, 950, 61],
                        col_ids=[7, SW + 9, 2 * SW + 5, SW + 70000])
        api.import_bits("i", "f", row_ids=[62] * 300,
                        col_ids=list(range(2 * SW + 100, 2 * SW + 400)),
                        clear=True)
    for jf, tf in zip(_frags(jh), _frags(th)):
        ids, cards = tf.row_cardinalities()
        jids, jcards = jf.row_cardinalities()
        assert np.array_equal(ids, jids) and np.array_equal(cards, jcards)
        assert np.array_equal(tf.positions(), jf.positions())
    for a, b in zip(merge_row_cards(_frags(th)),
                    jmerge_row_cards(_frags(jh))):
        assert np.array_equal(a, b)
    japi.executor.translate.close()
    tapi.executor.close()
    jh.close()


class _Cards:
    def __init__(self, ids, cards):
        self.out = (ids, cards)

    def row_cardinalities(self):
        return self.out


@pytest.mark.parametrize("top", [5000, 1 << 40])
def test_merge_row_cards_equal(top):
    """Dense row ids merge in one pass, sparse ones (up to 2^40) through a
    sort: both equal the reference's merge."""
    rng = np.random.default_rng(top % 97)
    frags = [_Cards(np.unique(rng.integers(0, top, 300).astype(np.uint64)),
                    None) for _ in range(20)]
    for fr in frags:
        fr.out = (fr.out[0], rng.integers(1, 9, len(fr.out[0])))
    frags.append(_Cards(np.empty(0, np.uint64), np.empty(0, np.int64)))
    got, want = merge_row_cards(frags), jmerge_row_cards(frags)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["array", "bitmap", "run", "mixed"])
def test_serialize_and_directory_positions_equal(kind):
    rng = np.random.default_rng({"array": 1, "bitmap": 2, "run": 3,
                                 "mixed": 4}[kind])
    if kind == "array":
        pos = (rng.integers(0, 5000, 3000).astype(np.uint64) << np.uint64(20)
               ) + rng.integers(0, SW, 3000).astype(np.uint64)
    elif kind == "bitmap":
        pos = rng.choice(1 << 17, 20000, replace=False).astype(np.uint64)
    elif kind == "run":
        pos = np.arange(5, 5000, dtype=np.uint64)
    else:
        pos = np.concatenate([
            rng.choice(1 << 17, 9000, replace=False).astype(np.uint64),
            np.arange(SW, SW + 300, dtype=np.uint64),
            (rng.integers(3, 90, 500).astype(np.uint64) << np.uint64(20))
            + rng.integers(0, SW, 500).astype(np.uint64)])
    blob = troaring.serialize(pos)
    assert blob == jroaring.serialize(pos) == troaring._serialize_plain(pos)
    assert np.array_equal(troaring.deserialize(blob), np.unique(pos))


# -- the sparse residency and its counts ------------------------------------


def test_sparse_arrays_and_counts_equal(data_dir, monkeypatch):
    jh, je = _jax(data_dir, monkeypatch, "off")
    th, te = _port(data_dir, "off")
    shards = tuple(range(SHARDS))
    js = je.planes._build_sparse(jh.index("i").field("f"), "standard",
                                 shards)
    ts = te.planes._build_sparse(th.index("i").field("f"), "standard",
                                 shards)
    assert np.array_equal(ts.word_idx.numpy(), np.asarray(js.word_idx))
    assert np.array_equal(ts.mask.numpy().view(np.uint32),
                          np.asarray(js.mask))
    assert np.array_equal(ts.row_ptr.numpy(), np.asarray(js.row_ptr))
    assert np.array_equal(ts.row_ids, js.row_ids)
    assert np.array_equal(ts.row_cards, js.row_cards)
    assert (ts.nbytes, ts.n_rows_pad) == (js.nbytes, js.n_rows_pad)
    assert te.planes.sparse_bytes(th.index("i").field("f"), "standard",
                                  shards) == je.planes.sparse_bytes(
        jh.index("i").field("f"), "standard", shards)
    rng = np.random.default_rng(5)
    for trial in range(4):
        fw = rng.integers(0, 1 << 32, (SHARDS, SW // 32), dtype=np.uint32)
        if trial == 1:
            fw[:] = 0xFFFFFFFF         # every count is the row's cardinality
        if trial == 2:
            fw &= np.uint32(0x80000000)  # only lane 31: negative int32
        tw = torch.from_numpy(fw.view(np.int32))
        want = np.asarray(jsparse.sparse_row_counts(
            jnp.asarray(fw), js.word_idx, js.mask, js.row_ptr))
        got = tsparse.sparse_row_counts(tw, ts.word_idx, ts.mask, ts.row_ptr)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        for k in (1, 5, 64, ts.n_rows_pad):
            jv, jslot = jsparse.topn_sparse(jnp.asarray(fw), js.word_idx,
                                            js.mask, js.row_ptr, k)
            tv, tslot = tsparse.topn_sparse(tw, ts.word_idx, ts.mask,
                                            ts.row_ptr, k)
            assert np.array_equal(tv.numpy(), np.asarray(jv)), (trial, k)
            assert np.array_equal(tslot.numpy(), np.asarray(jslot)), \
                (trial, k)


def test_topk_ties_in_slot_order():
    """All-tie counts: ``lax.top_k`` ranks equal values by ascending index,
    and so must the port (``torch.topk`` promises no order)."""
    n = 1 << 12
    counts = np.tile(np.array([3, 1, 3, 0, 3, 3, 2, 3], np.int32), n // 8)
    # CSR over a one-shard filter of all ones: row r has counts[r] bits
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nbits = int(row_ptr[-1])
    word_idx = (np.arange(nbits) % (SW // 32)).astype(np.int32)
    mask = np.ones(nbits, np.uint32)
    fw = np.full((1, SW // 32), 0xFFFFFFFF, np.uint32)
    jv, js = jsparse.topn_sparse(jnp.asarray(fw), jnp.asarray(word_idx),
                                 jnp.asarray(mask), jnp.asarray(row_ptr), 300)
    tv, ts = tsparse.topn_sparse(torch.from_numpy(fw.view(np.int32)),
                                 torch.from_numpy(word_idx),
                                 torch.from_numpy(mask.view(np.int32)),
                                 torch.from_numpy(row_ptr), 300)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert list(ts.numpy()[:5]) == [0, 2, 4, 5, 7]


# -- TopN through each representation ---------------------------------------

FILTERED = (
    "TopN(f, Row(g=0), n=5)",
    "TopN(f, Row(g=0))",
    "TopN(f, Row(g=0), n=7, ids=[3, 5, 61, 62])",
    "TopN(f, Row(g=1), tanimoto=40, n=5)",
    "TopN(f, Row(g=1), tanimoto=100)",
    "TopN(f, Row(g=0), _rowCounts=1)",
    "TopN(f, Row(g=0), tanimoto=0)",
    "TopN(f, Row(g=0), tanimoto=101)",
    "TopN(f, Row(g=5), n=3)",
    'TopN(k, Row(g=0), n=3)',
    'TopN(k, Row(g=0), tanimoto=20)',
    'TopN(f, Row(k="beta"), n=4)',
)
UNFILTERED = ("TopN(f, n=5)", "TopN(f)", "TopN(f, n=4, ids=[1, 2, 61])",
              "TopN(f, tanimoto=50)", "TopN(f, _rowCounts=1)", "TopN(k, n=2)",
              "TopN(k)")

# per path: the budget, the requests, and the port counter that must move
PATHS = {
    "dense": (None, FILTERED + UNFILTERED, "dense"),
    "host": (PLANE // 2, UNFILTERED, "host"),
    "sparse": (PLANE // 2, FILTERED, "sparse"),
    "streamed": (4096, FILTERED, "streamed"),
}


@pytest.mark.parametrize("config", ["off", "default"])
@pytest.mark.parametrize("path", list(PATHS))
def test_topn_paths_equal(data_dir, monkeypatch, config, path):
    budget, queries, counter = PATHS[path]
    kw = {} if budget is None else {"plane_budget": budget}
    jh, je = _jax(data_dir, monkeypatch, config, **kw)
    th, te = _port(data_dir, config, **kw)
    try:
        for q in queries:
            got = _answer(te, tjson, q)
            want = _answer(je, jjson, q)
            assert got == want, q
        served = te.serving_stats()["topnServed"]
        assert served[counter] > 0, served
        other = {p for p, n in served.items() if n and p != counter}
        if path == "dense":
            assert not other, served
        if path == "sparse":
            # the keyed field's dense plane fits; f's goes sparse
            assert other <= {"dense"}, served
            assert any(k[0] == "sparse" for k in te.planes._entries)
        if path == "streamed":
            assert te.planes.builds == 0
    finally:
        te.close()
        jh.close()


@pytest.mark.parametrize("config", ["off", "default"])
def test_serve_while_build_equal(data_dir, monkeypatch, config):
    """Past ``SYNC_BUILD_MAX`` the first TopN streams while the plane
    builds on a thread; after ``wait_builds`` the next reads the plane."""
    jh, je = _jax(data_dir, monkeypatch, config)
    th, te = _port(data_dir, config)
    je.planes.SYNC_BUILD_MAX = 1 << 20
    te.planes.SYNC_BUILD_MAX = 1 << 20
    q = "TopN(f, Row(g=0), n=6)"
    try:
        want = _answer(je, jjson, q)
        assert _answer(te, tjson, q) == want
        assert te.serving_stats()["topnServed"]["streamed"] == 1
        te.planes.wait_builds()
        je.planes.wait_builds()
        assert te.planes.builds == 1 and te.planes.build_failures == 0
        for q2 in (q, "TopN(f, Row(g=1), tanimoto=40, n=5)",
                   "TopN(f, Row(g=0), _rowCounts=1)"):
            assert _answer(te, tjson, q2) == _answer(je, jjson, q2), q2
        assert te.serving_stats()["topnServed"]["dense"] == 3
        assert te.planes.builds == 1
    finally:
        te.close()
        jh.close()


def test_background_build_failure_counted(data_dir, monkeypatch):
    th, te = _port(data_dir, "off")
    te.planes.SYNC_BUILD_MAX = 1 << 20

    def boom(*a, **k):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(te.planes, "_build_plane", boom)
    q = "TopN(f, Row(g=0), n=3)"
    first = _answer(te, tjson, q)
    te.planes.wait_builds()
    assert te.planes.build_failures == 1
    assert te.planes.stats()["buildFailures"] == 1
    # the request streamed and the next one streams again (and retries)
    assert _answer(te, tjson, q) == first
    te.planes.wait_builds()
    assert te.serving_stats()["topnServed"]["streamed"] == 2
    te.close()


@pytest.mark.parametrize("config", ["off", "default"])
def test_sparse_topn_sees_writes(copy_dir, monkeypatch, config):
    """A sparse residency takes no overlay: a write makes it stale and the
    next sparse TopN rebuilds it from the fragments."""
    q = "TopN(f, Row(g=0), n=5)"
    jh, je = _jax(copy_dir, monkeypatch, config, plane_budget=PLANE // 2)
    th, te = _port(copy_dir, config, plane_budget=PLANE // 2)
    try:
        assert _answer(te, tjson, q) == _answer(je, jjson, q)
        cols = [int(c) for c in jh.index("i").field("g").view("standard")
                .fragment(0).row(0).columns()]
        # through each package's own holder: f row 77 takes every column
        # of g row 0 in shard 0, more than any row holds
        changed = [JAPI(jh, je).import_bits("i", "f", row_ids=[77] * len(cols),
                                            col_ids=cols),
                   TAPI(th, te).import_bits("i", "f", row_ids=[77] * len(cols),
                                            col_ids=cols)]
        assert changed[0] == changed[1] == len(cols)
        got = _answer(te, tjson, q)
        assert got == _answer(je, jjson, q)
        assert got[0][0]["id"] == 77
        assert te.serving_stats()["topnServed"]["sparse"] == 2
    finally:
        te.close()
        jh.close()


def test_streamed_block_does_not_change_the_answer(data_dir):
    """The port clamps the streamed block to the view's pow2 row count; the
    reference's 64-row floor gives the same totals."""
    th, te = _port(data_dir, "off", plane_budget=4096)
    index = th.index("i")
    ctx = _Ctx(index, tuple(range(SHARDS)))
    field = index.field("f")
    fw = te._fused_bitmap(ctx, parse("Row(g=0)").calls[0])
    lane = SHARDS * (SW // 32) * 4
    clamped = te._topn_streamed(ctx, field, fw, True, 64 * lane)
    wide = te._topn_streamed(ctx, field, fw, True, 1 << 40)
    narrow = te._topn_streamed(ctx, field, fw, True, 16 * lane)
    for a, b in ((clamped, wide), (clamped, narrow)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    te.close()
