"""Multi-device serving in the port against ``pilosa_tpu``'s mesh on the CPU.

The reference runs its meshed executor over the 8-device virtual CPU mesh
that ``tests/conftest.py`` forces; the port's counterpart is
``virtual_placement(n, "cpu")``: n blocks of every plane on the CPU, each
block's work run per block and gathered (:mod:`pilosa_tpu_torch.parallel.
mesh`).  The same numpy data (12 shards, so every placement pads) answers:

- every request class of ``tests/test_parallel.py`` and
  ``tests/test_mesh_serving.py`` through the reference's meshed executor,
  the port's under eight blocks and the unmeshed port, JSON equal;
- the same under 1, 2, 4 and 8 blocks in both executor configurations
  against the unmeshed port, and the numpy oracle for pad-shard inertness;
- the 2-D ``(shard, words)`` placement's Counts, TopN and Row reads against
  the reference's 2x4 mesh;
- the programs of ``parallel.spmd`` (1-D, 2-D and the ingest step) against
  the reference's on the same inputs;
- the sparse TopN residency at 1, 2, 4 and 8 blocks against the numpy
  truth, one CSR triple per block;
- writes absorbed into blocked overlays (set and BSI) with no rebuild, a
  fold, ``Store`` and ``ClearRow`` under a placement;
- window fill above one, ``mesh_collective_seconds`` and ``mesh_devices``;
- the ``mesh`` status block and the diagnostics payload beside the
  reference's (device names aside: the port's blocks share one device);
- Extract, Limit and time ranges under a placement (refused by the first
  meshed executor), a 2-D Min and the 2-D Shift whose carry crossed word
  blocks, against the reference; the placement types.

Answers are bit-exact (tolerance 0).
"""

import json
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.result import result_to_json as jjson
from pilosa_tpu.obs.diagnostics import build_payload as jpayload
from pilosa_tpu.parallel import MeshPlacement as JMesh
from pilosa_tpu.parallel import MeshPlacement2D as JMesh2D
from pilosa_tpu.parallel import spmd as jspmd
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.engine.words import (SHARD_WIDTH, WORDS_PER_SHARD,
                                           pack_columns, unpack_columns)
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as tjson
from pilosa_tpu_torch.exec.errors import MeshNotSupported
from pilosa_tpu_torch.obs import Stats as TStats
from pilosa_tpu_torch.obs.diagnostics import build_payload as tpayload
from pilosa_tpu_torch.parallel import (MeshPlacement, MeshPlacement2D,
                                       local_placement, spmd)
from pilosa_tpu_torch.parallel.mesh import PAD_SHARD, Blocked, PerBlock
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads
from pilosa_tpu_torch.virtmesh import virtual_placement

share_cpu_threads()

N_SHARDS = 12   # not a multiple of 8: every plane carries pad shards
N_BITS = 6000
N_VALUED = 1500
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}

COUNTS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=1)))",
    "Count(Union(Row(f=0), Row(f=2), Row(g=1)))",
    "Count(Xor(Row(f=1), Row(g=1)))",
    "Count(Difference(Row(f=1), Row(g=1)))",
    "Count(Not(Row(g=1)))",
    "Count(Row(amount > 100))",
    "Count(Row(amount > 0))",
    "Count(Row(-100 <= amount <= 100))",
    "Count(Row(-250 <= amount <= 250))",
]
AGGREGATES = [
    "Sum(field=amount)", "Sum(Row(f=1), field=amount)",
    "Min(field=amount)", "Max(field=amount)",
    "Min(Row(g=1), field=amount)", "Max(Row(g=1), field=amount)",
    "Min(Row(f=99), field=amount)", "Max(Row(f=99), field=amount)",
    "Sum(Row(f=99), field=amount)",
]
READS = [
    "Row(f=3)", "Intersect(Row(f=1), Row(g=1))", "Row(amount > 0)",
    "TopN(f)", "TopN(f, n=3)", "TopN(f, Row(g=1))",
    "TopN(f, Row(g=1), n=4, tanimoto=20)",
    "GroupBy(Rows(f))", "GroupBy(Rows(f), aggregate=Sum(field=amount))",
    "GroupBy(Rows(f), aggregate=Count())",
    "GroupBy(Rows(f), having=Condition(count > 15))",
    "GroupBy(Rows(g), Rows(f))",
    "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))",
]
REQUESTS = COUNTS + AGGREGATES + READS
# what every block width answers beside the unmeshed port
WIDTH_REQUESTS = (COUNTS + AGGREGATES[:6]
                  + ["Row(f=3)", "TopN(f, Row(g=1))",
                     "GroupBy(Rows(g), aggregate=Sum(field=amount))"])
# compound Counts in one request: one batched window
BATCHED = "".join(COUNTS)


def _write(root: str) -> dict:
    """Index ``i`` through ``pilosa_tpu``'s store (the reference tests'
    shape: 8 rows of ``f``, ``g`` row 1 over half the columns, ``amount``
    over the first 1500); returns the numpy oracle."""
    rng = np.random.default_rng(42)
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("amount", JFO(type="int", min=-2000, max=2000))
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=N_BITS,
                      replace=False).astype(np.uint64)
    rows = rng.integers(0, 8, size=N_BITS).astype(np.uint64)
    idx.field("f").import_bits(rows, cols)
    half = cols[:N_BITS // 2]
    idx.field("g").import_bits(np.ones(len(half), np.uint64), half)
    vals = rng.integers(-500, 500, size=N_VALUED)
    idx.field("amount").import_values(cols[:N_VALUED], vals)
    idx.note_columns(cols)
    h.close()
    return {"f": {r: set(cols[rows == r].tolist()) for r in range(8)},
            "vals": dict(zip(cols[:N_VALUED].tolist(),
                             (int(v) for v in vals)))}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh"))
    return root, _write(root)


@pytest.fixture
def copy_dir(data, tmp_path):
    dst = str(tmp_path / "d")
    shutil.copytree(data[0], dst)
    return dst


def _answer(ex, to_json, pql: str):
    try:
        return json.loads(json.dumps([to_json(r) for r in
                                      ex.execute("i", pql)]))
    except Exception as e:  # noqa: BLE001 — compared between executors
        return ["error", type(e).__name__, str(e)]


@pytest.fixture(scope="module")
def trio(data, tmp_path_factory):
    """(reference meshed, port meshed over 8 blocks, port unmeshed), each
    holder over its own copy of the data."""
    dirs = [str(tmp_path_factory.mktemp(n)) for n in ("j", "t", "p")]
    for d in dirs:
        shutil.copytree(data[0], d, dirs_exist_ok=True)
    jh = JHolder(dirs[0]).open()
    jex = JExecutor(jh, placement=JMesh(jax.devices()))
    th, ph = THolder(dirs[1]).open(), THolder(dirs[2]).open()
    tex = TExecutor(th, placement=virtual_placement(8, "cpu"))
    pex = TExecutor(ph, device="cpu")
    yield jex, tex, pex
    for ex in (tex, pex):
        ex.close()
    jex.translate.close()
    for h in (jh, th, ph):
        h.close()


# -- the reference's meshed executor ----------------------------------------


@pytest.mark.parametrize("pql", REQUESTS + [BATCHED])
def test_requests_equal_the_reference_mesh(trio, pql):
    jex, tex, pex = trio
    want = _answer(jex, jjson, pql)
    assert want[0] != "error", want
    assert _answer(tex, tjson, pql) == want
    assert _answer(pex, tjson, pql) == want


def test_2d_placement_equals_the_reference(copy_dir, tmp_path):
    """The (shard, words) placement, 2 shard blocks x 4 word blocks: the
    Counts, TopN and the two Row reads of the reference's 2-D test."""
    jdir = str(tmp_path / "j2")
    shutil.copytree(copy_dir, jdir)
    jh = JHolder(jdir).open()
    jex = JExecutor(jh, placement=JMesh2D(jax.devices(), shard_size=2,
                                          words_size=4))
    th = THolder(copy_dir).open()
    tex = TExecutor(th, placement=MeshPlacement2D(["cpu"] * 8, shard_size=2,
                                                  words_size=4))
    try:
        for pql in COUNTS + ["TopN(f)", "Row(f=3)", "Row(amount > 0)",
                             "Sum(field=amount)"]:
            assert _answer(tex, tjson, pql) == _answer(jex, jjson, pql), pql
        # a descent across a shard's words sums each step over the shard's
        # word blocks: the reference's answer
        (mn,) = tex.execute("i", "Min(field=amount)")
        assert _answer(tex, tjson, "Min(field=amount)") == \
            _answer(jex, jjson, "Min(field=amount)")
        assert mn.value == min(_write_values())
    finally:
        tex.close()
        jex.translate.close()
        jh.close()
        th.close()


# -- block widths against the unmeshed port ----------------------------------


@pytest.fixture(scope="module")
def unmeshed_answers(data, tmp_path_factory):
    """The unmeshed port's answers to ``WIDTH_REQUESTS`` and ``BATCHED``,
    per configuration (computed once for every block width)."""
    d = str(tmp_path_factory.mktemp("plain"))
    shutil.copytree(data[0], d, dirs_exist_ok=True)
    h = THolder(d).open()
    out = {}
    for config, kw in CONFIGS.items():
        ex = TExecutor(h, device="cpu", **kw)
        out[config] = {pql: _answer(ex, tjson, pql)
                       for pql in WIDTH_REQUESTS + [BATCHED]}
        ex.close()
    h.close()
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_block_widths_equal_the_unmeshed_port(data, copy_dir,
                                               unmeshed_answers, n_blocks,
                                               config):
    truth = data[1]
    want = unmeshed_answers[config]
    h = THolder(copy_dir).open()
    meshed = TExecutor(h, placement=virtual_placement(n_blocks, "cpu"),
                       **CONFIGS[config])
    try:
        got = {pql: _answer(meshed, tjson, pql) for pql in want}
        assert got == want
        # pad shards are inert: the numpy oracle
        for r in range(8):
            assert meshed.execute("i", f"Count(Row(f={r}))") == \
                [len(truth["f"][r])]
        vals = list(truth["vals"].values())
        for pql, v in (("Sum(field=amount)", sum(vals)),
                       ("Min(field=amount)", min(vals)),
                       ("Max(field=amount)", max(vals))):
            assert got[pql][0]["value"] == v, pql
        assert got["Sum(field=amount)"][0]["count"] == len(vals)
        (gb,) = meshed.execute("i", "GroupBy(Rows(f))")
        assert {g.group[0].row_id: g.count for g in gb.groups} == \
            {r: len(c) for r, c in truth["f"].items() if c}
        assert meshed.planes.stats()["meshed"] is True
    finally:
        meshed.close()
        h.close()


def test_distinct_percentile_and_bitmap_calls(copy_dir):
    """The calls the reference files do not send answer as the unmeshed
    port does: Distinct, Percentile, Shift, UnionRows, ConstRow, All,
    IncludesColumn, Rows."""
    h = THolder(copy_dir).open()
    plain = TExecutor(h, device="cpu")
    meshed = TExecutor(h, placement=virtual_placement(4, "cpu"))
    try:
        for pql in ["Distinct(Row(g=1), field=amount)",
                    "Percentile(Row(f=2), field=amount, nth=90)",
                    "Count(Shift(Row(f=1), n=3))",
                    "Count(UnionRows(Rows(f)))",
                    f"ConstRow(columns=[1, {5 * SHARD_WIDTH + 9}])",
                    "Count(All())", "Rows(f)",
                    "IncludesColumn(Row(g=1), column=1)"]:
            assert _answer(meshed, tjson, pql) == _answer(plain, tjson, pql), \
                pql
    finally:
        meshed.close()
        plain.close()
        h.close()


def test_refused_calls_raise(copy_dir, tmp_path):
    """Extract, Limit and time ranges, which the first meshed executor
    refused, answer under a placement as the reference's meshed executor
    answers them; an operation no path routes over a blocked tensor is
    still refused."""
    jdir = str(tmp_path / "jr")
    h = THolder(copy_dir).open()
    h.index("i").create_field("t", _time_options())
    h.index("i").field("t").set_bit(1, 5, _stamp("2020-01-01T05:00"))
    h.close()
    shutil.copytree(copy_dir, jdir)
    jh = JHolder(jdir).open()
    jex = JExecutor(jh, placement=JMesh(jax.devices()))
    h = THolder(copy_dir).open()
    meshed = TExecutor(h, placement=virtual_placement(2, "cpu"))
    try:
        for pql in ["Extract(Row(f=1), Rows(g))",
                    "Count(Limit(Row(f=1), limit=3))",
                    "Count(Row(t=1, from='2020-01-01T00:00', "
                    "to='2020-01-02T00:00'))"]:
            want = _answer(jex, jjson, pql)
            assert want[0] != "error", want
            assert _answer(meshed, tjson, pql) == want, pql
        assert meshed.execute("i", "Count(Limit(Row(f=1), limit=3))") == [3]
        with pytest.raises(MeshNotSupported,
                           match="not supported by this port under a "
                                 "mesh placement"):
            torch.sum(meshed.planes.zeros(8))
    finally:
        meshed.close()
        jex.translate.close()
        jh.close()
        h.close()


def test_2d_shift_carries_across_word_blocks(copy_dir, tmp_path):
    """The first meshed executor lost a Shift's carry between word blocks:
    on a 2x4 placement ``Count(Shift(Row(f=1), n=40000))`` answered 632
    where the reference answers 712, in both configurations."""
    jdir = str(tmp_path / "js")
    shutil.copytree(copy_dir, jdir)
    jh = JHolder(jdir).open()
    jex = JExecutor(jh, placement=JMesh2D(jax.devices(), shard_size=2,
                                          words_size=4))
    h = THolder(copy_dir).open()
    try:
        for config, kw in CONFIGS.items():
            meshed = TExecutor(h, placement=MeshPlacement2D(
                ["cpu"] * 8, shard_size=2, words_size=4), **kw)
            try:
                for pql in ("Count(Shift(Row(f=1), n=40000))",
                            "Shift(Row(f=1), n=40000)"):
                    assert _answer(meshed, tjson, pql) == \
                        _answer(jex, jjson, pql), (config, pql)
                assert meshed.execute(
                    "i", "Count(Shift(Row(f=1), n=40000))") == [712]
            finally:
                meshed.close()
    finally:
        jex.translate.close()
        jh.close()
        h.close()


def _stamp(text: str):
    from datetime import datetime
    return datetime.fromisoformat(text)


def _write_values() -> list:
    """``_write``'s ``amount`` values (the same draws)."""
    rng = np.random.default_rng(42)
    rng.choice(N_SHARDS * SHARD_WIDTH, size=N_BITS, replace=False)
    rng.integers(0, 8, size=N_BITS)
    return rng.integers(-500, 500, size=N_VALUED).tolist()


def _time_options():
    from pilosa_tpu_torch.store import FieldOptions
    return FieldOptions(type="time", time_quantum="YMD")


# -- writes ------------------------------------------------------------------


def test_overlays_absorb_without_rebuild(data, copy_dir):
    """Set and BSI writes absorb into blocked overlays: answers follow the
    oracle, no base plane rebuilds, and the overlay has one part per
    block."""
    truth = {"f": {r: set(c) for r, c in data[1]["f"].items()},
             "vals": dict(data[1]["vals"])}
    h = THolder(copy_dir).open()
    ex = TExecutor(h, placement=virtual_placement(8, "cpu"))
    try:
        ex.execute("i", "Sum(field=amount)")
        ex.execute("i", "TopN(f)")
        builds0, absorbs0 = ex.planes.builds, ex.planes.delta_absorbs
        wcols = list(truth["vals"])[:64]
        wvals = list(range(1, 65))
        h.index("i").field("amount").import_values(
            np.array(wcols, np.uint64), wvals)
        truth["vals"].update(zip(wcols, wvals))
        all_set = set().union(*truth["f"].values())
        newcols = [c + 1 for c in sorted(truth["f"][1])[:48]
                   if c + 1 not in all_set and (c + 1) % SHARD_WIDTH][:32]
        for c in newcols:
            assert ex.execute("i", f"Set({c}, f=1)") == [True]
        truth["f"][1].update(newcols)
        vals = list(truth["vals"].values())
        (s,) = ex.execute("i", "Sum(field=amount)")
        assert (s.value, s.count) == (sum(vals), len(vals))
        (mn,) = ex.execute("i", "Min(field=amount)")
        assert mn.value == min(vals)
        assert ex.execute("i", "Count(Row(amount > 0))") == \
            [sum(1 for v in vals if v > 0)]
        (tn,) = ex.execute("i", "TopN(f)")
        assert sorted((p.count, p.id) for p in tn.pairs) == sorted(
            (len(c), r) for r, c in truth["f"].items())
        assert ex.execute("i", "Count(Row(f=1))") == [len(truth["f"][1])]
        assert ex.planes.builds == builds0
        assert ex.planes.delta_absorbs > absorbs0
        for key, (_, ps, _) in ex.planes._entries.items():
            if ps.delta is not None:
                assert len(ps.delta.parts) == 8, key
    finally:
        ex.close()
        h.close()


def test_fold_store_and_clear_row(copy_dir):
    """Writes past a small overlay fold into new blocked planes, and
    Store / ClearRow write every real shard (never a pad shard)."""
    h = THolder(copy_dir).open()
    plain = TExecutor(h, device="cpu", delta_cells=64,
                      delta_compact_fraction=0.25)
    meshed = TExecutor(h, placement=virtual_placement(4, "cpu"),
                       delta_cells=64, delta_compact_fraction=0.25)
    try:
        meshed.execute("i", "TopN(f)")
        rng = np.random.default_rng(3)
        for i, c in enumerate(rng.choice(N_SHARDS * SHARD_WIDTH, 200,
                                         replace=False)):
            meshed.execute("i", f"Set({int(c)}, f={int(c) % 8})")
            if i % 10 == 9:
                meshed.execute("i", "TopN(f)")  # absorbs, then folds
        meshed.planes.wait_compactions()
        assert meshed.planes.delta_compactions + \
            meshed.planes.incremental_applied > 0
        meshed.execute("i", "Store(Intersect(Row(f=1), Row(g=1)), f=20)")
        meshed.execute("i", "ClearRow(f=2)")
        for pql in ["TopN(f)", "Count(Row(f=20))", "Count(Row(f=2))",
                    "Count(Union(Row(f=1), Row(f=3)))", "Row(f=5)"]:
            assert _answer(meshed, tjson, pql) == _answer(plain, tjson, pql), \
                pql
        assert PAD_SHARD not in h.index("i").field("f").view(
            "standard").fragments
        ps = meshed.planes.field_plane("i", h.index("i").field("f"),
                                       "standard", meshed._shards_for(
                                           h.index("i"), None))
        assert isinstance(ps.plane, Blocked) and len(ps.plane.blocks) == 4
    finally:
        meshed.close()
        plain.close()
        h.close()


# -- windows and telemetry ---------------------------------------------------


def test_window_fill_and_mesh_metrics(copy_dir):
    h = THolder(copy_dir).open()
    stats = TStats()
    ex = TExecutor(h, placement=virtual_placement(8, "cpu"), stats=stats,
                   max_concurrent=32)
    try:
        want = {pql: ex.execute("i", pql)
                for pql in ("Sum(field=amount)", "Count(Row(f=1))")}
        errs = []

        def worker(barrier):
            barrier.wait()
            for _ in range(4):
                for pql, w in want.items():
                    got = ex.execute("i", pql)
                    if _canon(got) != _canon(w):
                        errs.append(pql)

        filled = False
        for _ in range(5):
            barrier = threading.Barrier(8)
            ts = [threading.Thread(target=worker, args=(barrier,))
                  for _ in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            summ = stats.histogram_summary("pipeline_window_fill")
            if any(v["sum"] > v["count"] for v in summ.values()):
                filled = True
                break
        assert not errs
        assert filled, "no window coalesced more than one item"
        assert stats.histogram_summary("mesh_collective_seconds")
        assert stats.snapshot()["gauges"]["mesh_devices"][()] == 8
        assert ex.batcher.placement_key == ("mesh1d", "shard", 8)
    finally:
        ex.close()
        h.close()


def _canon(results):
    return [(r.value, r.count) if hasattr(r, "value") else r
            for r in results]


def test_mesh_status_and_diagnostics_beside_the_reference(copy_dir,
                                                          tmp_path):
    jdir = str(tmp_path / "jd")
    shutil.copytree(copy_dir, jdir)
    jh = JHolder(jdir).open()
    jex = JExecutor(jh, placement=JMesh(jax.devices()))
    th = THolder(copy_dir).open()
    stats = TStats()
    tex = TExecutor(th, placement=virtual_placement(8, "cpu"), stats=stats)
    plain = TExecutor(th, device="cpu")
    try:
        for ex in (jex, tex):
            ex.execute("i", "TopN(f)")
            ex.execute("i", "Sum(field=amount)")
        jm, tm = jex.mesh_status(), tex.mesh_status()
        assert set(tm) == set(jm)
        assert (tm["devices"], tm["axis"]) == (jm["devices"], jm["axis"])
        # both hold f's plane and amount's bit plane over 16 shards
        assert tm["paddedShards"] == jm["paddedShards"] == 8
        # eight blocks on one device add into its one entry
        assert list(tm["perDeviceBytes"]) == ["cpu"]
        assert tm["perDeviceBytes"]["cpu"] == sum(jm["perDeviceBytes"]
                                                  .values())
        assert stats.snapshot()["gauges"]["plane_shard_bytes"] == \
            {(("device", "cpu"),): tm["perDeviceBytes"]["cpu"]}
        jp, tp = jpayload(jh, executor=jex), tpayload(th, executor=tex)
        assert tp["mesh"] == tm and jp["mesh"]["devices"] == 8
        assert plain.mesh_status() is None
        assert "mesh" not in tpayload(th, executor=plain)
        assert plain.planes.stats()["meshed"] is False
    finally:
        tex.close()
        plain.close()
        jex.translate.close()
        jh.close()
        th.close()


# -- the programs -------------------------------------------------------------


def _rows(rng, n_shards, k):
    cols = [rng.choice(SHARD_WIDTH, k, replace=False)
            for _ in range(n_shards)]
    return cols, np.stack([pack_columns(c) for c in cols])


def test_spmd_programs_equal_the_reference():
    rng = np.random.default_rng(5)
    jmesh = JMesh(jax.devices())
    place = virtual_placement(8, "cpu")
    a_cols, a = _rows(rng, 8, 1000)
    b_cols, b = _rows(rng, 8, 1000)
    expect = sum(len(np.intersect1d(x, y)) for x, y in zip(a_cols, b_cols))
    ja, jb = jmesh.place(a), jmesh.place(b)
    ta, tb = place.place(a), place.place(b)
    assert int(spmd.intersect_count(ta, tb)) == expect == \
        int(jspmd.intersect_count(ja, jb))
    assert int(spmd.make_intersect_count_psum(place)(ta, tb)) == expect == \
        int(jspmd.make_intersect_count_psum(jmesh.mesh)(ja, jb))
    assert int(spmd.union_count(ta, tb)) == int(jspmd.union_count(ja, jb))
    plane = np.zeros((8, 16, WORDS_PER_SHARD), np.uint32)
    for s in range(8):
        for r in range(16):
            plane[s, r] = pack_columns(rng.choice(
                SHARD_WIDTH, int(rng.integers(0, 500)), replace=False))
    plane[:, 3] = plane[:, 4]  # a tie
    filt = np.full((8, WORDS_PER_SHARD), 0xFFFFFFFF, np.uint32)
    tp, tf = place.place(plane), place.place(filt)
    jv, js = jspmd.make_topn_psum(jmesh.mesh, n=6)(jmesh.place(plane),
                                                   jmesh.place(filt))
    for tv, ts in (spmd.make_topn_psum(place, n=6)(tp, tf),
                   spmd.topn(tp, tf, 6)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # BSI bit counts over a plane of signed values
    bsi = np.zeros((8, 5, WORDS_PER_SHARD), np.uint32)
    bsi[:, 0] = pack_columns(np.arange(0, 4000, 3))
    bsi[:, 1] = pack_columns(np.arange(0, 4000, 9))
    for b in range(3):
        bsi[:, 2 + b] = pack_columns(rng.choice(4000, 900, replace=False))
    got = spmd.bsi_bit_counts(place.place(bsi), tf)
    want = jspmd.bsi_bit_counts(jmesh.place(bsi), jmesh.place(filt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = spmd.make_bsi_sum_psum(place)(bsi, filt)
    want = jspmd.make_bsi_sum_psum(jmesh.mesh)(jmesh.place(bsi),
                                               jmesh.place(filt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_2d_programs_equal_the_reference():
    rng = np.random.default_rng(6)
    jmesh = JMesh2D(jax.devices(), shard_size=2, words_size=4)
    place = MeshPlacement2D(["cpu"] * 8, shard_size=2, words_size=4)
    a_cols, a = _rows(rng, 4, 2000)
    b_cols, b = _rows(rng, 4, 2000)
    expect = sum(len(np.intersect1d(x, y)) for x, y in zip(a_cols, b_cols))
    got = spmd.make_intersect_count_psum2d(place)(a, b)
    assert int(got) == expect == int(jspmd.make_intersect_count_psum2d(
        jmesh.mesh)(jmesh.place(a), jmesh.place(b)))
    plane = np.zeros((4, 8, WORDS_PER_SHARD), np.uint32)
    for s in range(4):
        for r in range(8):
            plane[s, r] = pack_columns(rng.choice(
                SHARD_WIDTH, int(rng.integers(1, 300)), replace=False))
    filt = np.full((4, WORDS_PER_SHARD), 0xFFFFFFFF, np.uint32)
    tv, ts = spmd.make_topn_psum2d(place, n=3)(plane, filt)
    jv, js = jspmd.make_topn_psum2d(jmesh.mesh, n=3)(jmesh.place(plane),
                                                     jmesh.place(filt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ingest_step_equals_the_reference():
    from pilosa_tpu.engine.words import coalesce_updates
    rng = np.random.default_rng(7)
    words = np.zeros((8, WORDS_PER_SHARD), np.uint32)
    words[:, 5] = 0x10
    idx = np.full((8, 64), WORDS_PER_SHARD, np.int64)  # pad: dropped
    mask = np.zeros((8, 64), np.uint32)
    for s in range(8):
        ui, um = coalesce_updates(rng.choice(SHARD_WIDTH, 50, replace=False))
        idx[s, :len(ui)] = ui
        mask[s, :len(um)] = um
    place = virtual_placement(8, "cpu")
    got = spmd.make_ingest_step(place)(words, idx, mask).full().numpy()
    jmesh = JMesh(jax.devices())
    want = np.asarray(jspmd.make_ingest_step(jmesh.mesh)(
        jmesh.place(words), jmesh.place(idx), jmesh.place(mask)))
    np.testing.assert_array_equal(got.view(np.uint32), want)


# -- sparse residency ---------------------------------------------------------

N_SPARSE_ROWS = 3000
SPARSE_BUDGET = 8 << 20


@pytest.fixture(scope="module")
def sparse_dir(tmp_path_factory):
    rng = np.random.default_rng(1234)
    root = str(tmp_path_factory.mktemp("sparse_mesh"))
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("big")
    idx.create_field("f")
    n = 20000
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n).astype(np.uint64)
    rows = rng.integers(0, N_SPARSE_ROWS, size=n).astype(np.uint64)
    idx.field("big").import_bits(rows, cols)
    fcols = np.unique(cols[: n // 2])
    idx.field("f").import_bits(np.ones(len(fcols), np.uint64), fcols)
    idx.note_columns(cols)
    h.close()
    fset = set(fcols.tolist())
    want: dict = {}
    for r, c in set(zip(rows.tolist(), cols.tolist())):
        if c in fset:
            want[r] = want.get(r, 0) + 1
    truth = sorted(((cnt, r) for r, cnt in want.items()),
                   key=lambda t: (-t[0], t[1]))
    return root, truth


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_sparse_topn_block_widths(sparse_dir, tmp_path, n_blocks):
    root, truth = sparse_dir
    d = str(tmp_path / "s")
    shutil.copytree(root, d)
    h = THolder(d).open()
    ex = TExecutor(h, placement=virtual_placement(n_blocks, "cpu"),
                   plane_budget=SPARSE_BUDGET)
    try:
        (got,) = ex.execute("i", f"TopN(big, Row(f=1), n={N_SPARSE_ROWS})")
        assert [(p.count, p.id) for p in got.pairs] == truth
        (got2,) = ex.execute("i", "TopN(big, Row(f=1))")
        assert [(p.count, p.id) for p in got2.pairs] == truth
        ss = [v[1] for k, v in ex.planes._entries.items()
              if k[0] == "sparse"][0]
        assert ex.serving_stats()["topnServed"]["sparse"] == 2
        if n_blocks > 1:
            assert isinstance(ss.word_idx, PerBlock)
            assert len(ss.word_idx.parts) == n_blocks
        else:
            assert isinstance(ss.word_idx, torch.Tensor)
        # the budget's estimate never admits a residency it undercounts
        assert ss.nbytes <= ex.planes.sparse_bytes(
            h.index("i").field("big"), "standard", ss.shards)
    finally:
        ex.close()
        h.close()


def test_sparse_meshed_equals_unmeshed(sparse_dir, tmp_path):
    root, _ = sparse_dir
    d = str(tmp_path / "s")
    shutil.copytree(root, d)
    h = THolder(d).open()
    plain = TExecutor(h, device="cpu", plane_budget=SPARSE_BUDGET)
    meshed = TExecutor(h, placement=virtual_placement(8, "cpu"),
                       plane_budget=SPARSE_BUDGET)
    try:
        for pql in ["TopN(big, Row(f=1), n=10)",
                    "TopN(big, Row(f=1), n=10, tanimoto=20)"]:
            assert _answer(meshed, tjson, pql) == _answer(plain, tjson, pql)
    finally:
        meshed.close()
        plain.close()
        h.close()


# -- placement types ---------------------------------------------------------


def test_placements():
    p = MeshPlacement(["cpu"] * 4)
    assert p.key == ("mesh1d", "shard", 4) == \
        JMesh(jax.devices()[:4]).key
    assert p.pad_shards((1, 2, 3, 4, 5)) == (1, 2, 3, 4, 5, PAD_SHARD,
                                             PAD_SHARD, PAD_SHARD)
    assert p.layout(8) == ((0, 2, None, None), (2, 4, None, None),
                           (4, 6, None, None), (6, 8, None, None))
    with pytest.raises(ValueError):
        p.layout(6)
    p2 = MeshPlacement2D(["cpu"] * 8, shard_size=2, words_size=4)
    assert (p2.n_devices, p2.words_size) == (2, 4)
    assert p2.key == JMesh2D(jax.devices(), shard_size=2,
                             words_size=4).key
    for mod, devs in ((MeshPlacement2D, ["cpu"] * 6),
                      (JMesh2D, jax.devices()[:6])):
        with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices"):
            mod(devs, shard_size=2, words_size=4)
    if not torch.cuda.is_available():
        assert local_placement() is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            virtual_placement(4)


def test_blocked_gather_and_refusals():
    place = virtual_placement(4, "cpu")
    host = np.arange(8 * 3 * 64, dtype=np.uint32).reshape(8, 3, 64)
    b = place.place(host)
    assert b.shape == (8, 3, 64) and len(b.blocks) == 4
    np.testing.assert_array_equal(b.full().numpy().view(np.uint32), host)
    rows = b[:, 1] & b[:, 2]
    np.testing.assert_array_equal(rows.full().numpy().view(np.uint32),
                                  host[:, 1] & host[:, 2])
    outs = b.map(lambda x: x[:, 0, 0].clone(), b)
    np.testing.assert_array_equal(b.gather(outs).numpy(),
                                  host[:, 0, 0].view(np.int32))
    assert int(b.total([o.sum() for o in outs])) == \
        int(host[:, 0, 0].astype(np.int64).sum())
    for bad in (lambda: b[0], lambda: b.sum(),
                lambda: torch.cat([b, b]), lambda: b == b):
        with pytest.raises((MeshNotSupported, AttributeError)):
            bad()
    # a 2-D placement's counts are partial per word block and sum per
    # shard when gathered
    p2 = MeshPlacement2D(["cpu"] * 4, shard_size=2, words_size=2)
    words = np.stack([pack_columns(np.arange(s, 60000, 7 + s))
                      for s in range(4)])
    from pilosa_tpu_torch.engine import kernels
    counts = kernels.count(p2.place(words))
    assert counts.partial
    np.testing.assert_array_equal(
        counts.gather().numpy(),
        [len(unpack_columns(w)) for w in words])
    with pytest.raises(MeshNotSupported):
        counts.full()


@pytest.mark.parametrize("combine", ["blocked", "total", "gather",
                                     "by_argument", "concat"])
def test_per_block_combine(combine):
    """``per_block``'s ways of combining per-block outputs, against the
    function run on the whole tensor; dict and tuple outputs combine
    entry by entry, and over word-split blocks a "gather" sums each shard
    range's word blocks where a "concat" keeps them apart."""
    from pilosa_tpu_torch.parallel.mesh import per_block
    place = virtual_placement(4, "cpu")
    host = np.arange(8 * 3 * 64, dtype=np.uint32).reshape(8, 3, 64)
    plain = torch.from_numpy(host.view(np.int32))
    b = place.place(host)

    def per_shard(x, k):
        return {"rows": x[:, k].clone(), "n": (x[:, k, :4].sum(1),
                                               x[:, k, 0].clone())}

    def block_sums(t):   # per-block outputs added: 4 blocks of 2 shards
        return t.reshape((4, 2) + tuple(t.shape[1:])).sum(0)

    if combine == "by_argument":
        how = per_block(combine=lambda a: "total" if a["k"] else "gather")(
            per_shard)
        assert torch.equal(how(b, 0)["n"][0], per_shard(plain, 0)["n"][0])
        assert torch.equal(how(b, 1)["n"][1],
                           block_sums(per_shard(plain, 1)["n"][1]))
        # over 2 shard blocks x 2 word blocks a gather sums a shard's word
        # blocks: each shard's first words, once per word block
        p2 = MeshPlacement2D(["cpu"] * 4, shard_size=2, words_size=2)
        firsts = how(p2.place(host), 0)["n"][1]
        assert torch.equal(firsts, plain[:, 0, 0] + plain[:, 0, 32])
        return
    if combine == "concat":
        p2 = MeshPlacement2D(["cpu"] * 4, shard_size=2, words_size=2)
        got = per_block(combine="concat")(per_shard)(p2.place(host), 1)
        # block (i, j) holds shards [4i, 4i + 4) and words [32j, 32j + 32)
        want = torch.cat([plain[4 * i:4 * i + 4, 1, 32 * j]
                          for i in range(2) for j in range(2)])
        assert torch.equal(got["n"][1], want)
        return
    got = per_block(combine=combine)(per_shard)(b, 2)
    want = per_shard(plain, 2)
    if combine == "blocked":
        assert isinstance(got["rows"], Blocked)
        assert torch.equal(got["rows"].full(), want["rows"])
        assert torch.equal(got["n"][1].full(), want["n"][1])
    elif combine == "gather":
        assert torch.equal(got["rows"], want["rows"])
        assert all(torch.equal(g, w) for g, w in zip(got["n"], want["n"]))
    else:
        assert torch.equal(got["rows"], block_sums(want["rows"]))
        assert torch.equal(got["n"][0], block_sums(want["n"][0]))
