"""``Rows`` and ``GroupBy`` through the port's store, executor and API,
against the JAX package on the same on-disk holder and a numpy oracle.

One data directory (set fields ``f``, ``g``, ``h`` and ``k``, the last
with a row id past 2^39, and int fields ``amount``, ``score`` with a
non-zero base, ``sparse`` with few values and ``big`` of depth 31, over
3 shards, written by the JAX package) answers the request list through
the JAX ``API`` and the port's, in both executor configurations ("off"
and "default"); the JSON must be equal, exactly.  Also here: the
validation errors, blocked against unblocked streaming, ``groupby_out``
against the JAX package's on the same planes (with and without a BSI
overlay), the rows planes' refresh after a set import, aggregates over
a BSI overlay after ``importValue``, the ``groupby`` batcher kind's
dedupe, and a failing GroupBy launch."""

import json
import shutil
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import groupby as jgb
from pilosa_tpu.exec.executor import ExecutionError as JExecutionError
from pilosa_tpu.ingest.delta import DeltaMirror as JMirror
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu.store.field import FieldOptions as JFieldOptions
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import GroupCountsResult
from pilosa_tpu_torch.exec import groupby as tgb
from pilosa_tpu_torch.exec.executor import ExecutionError
from pilosa_tpu_torch.exec.planes import PlaneCache
from pilosa_tpu_torch.ingest.delta import DeltaMirror
from pilosa_tpu_torch.store import Holder as THolder
from test_torch_batcher import _run_threads
from test_torch_bsi import make_plane, port
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SHARDS, SW = 3, 1 << 20
N_COLS = SHARDS * SW
BIG_ROW = (1 << 39) + 5
INT_FIELDS = {
    "amount": {"type": "int", "min": -5000, "max": 5000},
    "score": {"type": "int", "min": 10, "max": 1000},
    "sparse": {"type": "int", "min": -50, "max": 50},
    "big": {"type": "int", "min": -(2**31 - 1), "max": 2**31 - 1},
}
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}

READS = [
    "Rows(f)", "Rows(f, limit=3)", "Rows(f, previous=2)",
    "Rows(f, previous=2, limit=2)", "Rows(f, column=7)",
    f"Rows(g, column={2 * SW + 11})", "Rows(k)", "Rows(amount)",
    "GroupBy(Rows(f))", "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), Rows(h))", "GroupBy(Rows(k), Rows(g))",
    "GroupBy(Rows(g), Rows(k))",
    "GroupBy(Rows(f, limit=2), Rows(f, previous=1, limit=3))",
    "GroupBy(Rows(f), filter=Row(g=1))",
    "GroupBy(Rows(f), Rows(g), filter=Row(amount > 0))",
    "GroupBy(Rows(f), aggregate=Count())",
    "GroupBy(Rows(f), aggregate=Sum(field=amount))",
    "GroupBy(Rows(f), aggregate=Min(field=amount))",
    "GroupBy(Rows(f), aggregate=Max(field=amount))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=amount))",
    "GroupBy(Rows(f), Rows(g), aggregate=Min(field=amount))",
    "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))",
    "GroupBy(Rows(f), aggregate=Sum(field=score))",
    "GroupBy(Rows(f), Rows(h), aggregate=Min(field=score))",
    "GroupBy(Rows(f), aggregate=Max(field=score))",
    "GroupBy(Rows(f), Rows(g), aggregate=Min(field=sparse))",
    "GroupBy(Rows(f), Rows(g), aggregate=Max(field=sparse))",
    "GroupBy(Rows(f), aggregate=Sum(field=big))",
    "GroupBy(Rows(f), aggregate=Min(field=big))",
    "GroupBy(Rows(f), Rows(g), aggregate=Max(field=big))",
    "GroupBy(Rows(f), Rows(g), having=Condition(count > 1500))",
    "GroupBy(Rows(f), having=Condition(3000 <= count <= 3400))",
    "GroupBy(Rows(f), aggregate=Sum(field=amount), "
    "having=Condition(sum > 0))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=amount), "
    "having=Condition(sum < 0), limit=2)",
    "GroupBy(Rows(f), Rows(g), aggregate=Min(field=sparse), "
    "having=Condition(count > 1100))",
    "GroupBy(Rows(f), Rows(g), previous=[2, 1])",
    "GroupBy(Rows(f), Rows(g), limit=5)",
    "GroupBy(Rows(f), Rows(g), previous=[1, 0], limit=4)",
    "GroupBy(Rows(g), Rows(f), having=Condition(count > 1000), limit=4, "
    "previous=[0, 3])",
    "GroupBy(Rows(f, column=7), Rows(g))",
    "GroupBy(Rows(f), Rows(g, previous=5))",
]
ERRORS = [
    "GroupBy(Rows(f), having=Condition(sum > 1))",
    "GroupBy(Rows(f), having=Condition(nope > 1))",
    "GroupBy(Rows(f), having=Row(f=1))",
    "GroupBy(Rows(f), aggregate=TopN(f))",
    "GroupBy(Rows(f), aggregate=Sum(field=g))",
    "GroupBy(Rows(f), Rows(g), previous=[1])",
    "GroupBy(filter=Row(f=1))",
    "Rows()",
]


def _pairs(rng, rows: int, n: int):
    cols = rng.choice(N_COLS, n, replace=False).astype(np.uint64)
    return rng.integers(0, rows, n).astype(np.uint64), cols


def _write_index(root: str) -> dict:
    """The JAX package writes the holder; returns what the numpy oracle
    needs: per set field {row: bool[N_COLS]}, per int field the values
    and their exists mask."""
    rng = np.random.default_rng(17)
    h = JHolder(root).open()
    idx = h.create_index("i")
    data: dict = {}
    for name, rows, n in (("f", 6, 20000), ("g", 3, 20000),
                          ("h", 3, 15000), ("k", 2, 4000)):
        idx.create_field(name)
        r, c = _pairs(rng, rows, n)
        if name == "k":
            r = np.where(r == 1, np.uint64(BIG_ROW), np.uint64(3))
        idx.field(name).import_bits(r, c)
        idx.note_columns(c)
        data[name] = {int(row): np.isin(np.arange(N_COLS, dtype=np.uint64),
                                        c[r == row])
                      for row in np.unique(r)}
    for name, opts in INT_FIELDS.items():
        idx.create_field(name, JFieldOptions(created_at=1.0, **opts))
        n = 200 if name == "sparse" else 30000
        cols = rng.choice(SW if name == "sparse" else N_COLS, n,
                          replace=False).astype(np.uint64)
        vals = rng.integers(opts["min"], opts["max"] + 1, n)
        idx.field(name).import_values(cols, vals.tolist())
        idx.note_columns(cols)
        full = np.zeros(N_COLS, np.int64)
        full[cols.astype(np.int64)] = vals
        exists = np.zeros(N_COLS, bool)
        exists[cols.astype(np.int64)] = True
        data[name] = (full, exists)
    h.close()
    return data


def _jax_api(root: str, monkeypatch, config: str):
    monkeypatch.setenv("PILOSA_PALLAS_INTERPRET", "1")
    holder = JHolder(root).open()
    ex = JExecutor(holder, plane_paging=False, kernel_tier="pallas",
                   **CONFIGS[config])
    return holder, JAPI(holder, ex)


def _port_api(root: str, config: str, **kw):
    holder = THolder(root).open()
    return holder, TAPI(holder, TExecutor(holder, device="cpu",
                                          **CONFIGS[config], **kw))


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("groupby") / "data")
    return root, _write_index(root)


@pytest.fixture(scope="module")
def jax_answers(index):
    mp = pytest.MonkeyPatch()
    jh, japi = _jax_api(index[0], mp, "off")
    try:
        return {q: japi.query("i", q)["results"] for q in READS}
    finally:
        jh.close()
        mp.undo()


@pytest.fixture(scope="module", params=list(CONFIGS))
def port_api(index, request):
    holder, api = _port_api(index[0], request.param)
    yield api
    api.executor.close()
    holder.close()


@pytest.mark.parametrize("pql", READS)
def test_same_json(port_api, jax_answers, pql):
    assert port_api.query("i", pql) == {"results": jax_answers[pql]}


def test_rest_query_serves_rows_and_groupby(port_api, jax_answers):
    """REST ``/index/i/query`` answers Rows and GroupBy with the JAX
    package's JSON."""
    server = TServer(port_api, "127.0.0.1", 0).start()
    try:
        base = "http://%s:%d" % server.address
        for pql in ("Rows(f, limit=3)", "GroupBy(Rows(f), Rows(g))",
                    "GroupBy(Rows(f), aggregate=Sum(field=amount))"):
            req = urllib.request.Request(base + "/index/i/query",
                                         data=pql.encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert json.loads(resp.read()) == \
                    {"results": jax_answers[pql]}, pql
    finally:
        server.close()


@pytest.mark.parametrize("pql", ERRORS)
def test_errors_alike(index, port_api, monkeypatch, pql):
    jh, japi = _jax_api(index[0], monkeypatch, "off")
    try:
        with pytest.raises(JExecutionError):
            japi.executor.execute("i", pql)
    finally:
        jh.close()
    with pytest.raises(ExecutionError):
        port_api.executor.execute("i", pql)


# ---------------------------------------------------------------------------
# the numpy oracle
# ---------------------------------------------------------------------------


def _groups(data: dict, levels: list, filt=None, agg=None):
    """[(row ids, count, agg or None)] in lexicographic order."""
    grids = np.meshgrid(*[sorted(data[f]) for f in levels], indexing="ij")
    out = []
    for combo in zip(*(g.reshape(-1) for g in grids)):
        mask = np.ones(N_COLS, bool) if filt is None else filt.copy()
        for f, r in zip(levels, combo):
            mask &= data[f][int(r)]
        n = int(mask.sum())
        if not n:
            continue
        val = None
        if agg is not None:
            kind, field = agg
            vals, exists = data[field]
            live = vals[mask & exists]
            if kind == "Sum":
                val = int(live.sum())
            elif len(live):
                val = int(live.min() if kind == "Min" else live.max())
        out.append(([int(r) for r in combo], n, val))
    return out


def _as_tuples(result: GroupCountsResult):
    return [([fr.row_id for fr in gc.group], gc.count, gc.agg)
            for gc in result.groups]


@pytest.mark.parametrize("levels,agg", [
    (["f"], None), (["f", "g"], None), (["f", "g", "h"], None),
    (["k", "g"], None), (["f", "g"], ("Sum", "amount")),
    (["f", "h"], ("Min", "amount")), (["g", "f"], ("Max", "score")),
    (["f", "g"], ("Min", "sparse")), (["f"], ("Max", "big"))])
def test_groupby_equals_numpy_oracle(index, port_api, levels, agg):
    _, data = index
    pql = "GroupBy(" + ", ".join(f"Rows({f})" for f in levels)
    if agg is not None:
        pql += f", aggregate={agg[0]}(field={agg[1]})"
    (got,) = port_api.executor.execute("i", pql + ")")
    assert _as_tuples(got) == _groups(data, levels, agg=agg)


def test_filtered_groupby_equals_numpy_oracle(index, port_api):
    _, data = index
    (got,) = port_api.executor.execute(
        "i", "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))")
    assert _as_tuples(got) == _groups(data, ["g"], filt=data["f"][1],
                                      agg=("Max", "amount"))


def test_index_shapes(index):
    """The fields behind the cases: a non-zero base, a depth past the
    Min/Max int32 reconstruction, empty Min/Max cells, a large row id."""
    root, data = index
    holder = THolder(root).open()
    try:
        idx = holder.index("i")
        assert idx.field("score").options.base != 0
        assert idx.field("big").options.bit_depth > tgb.MINMAX_MAX_DEPTH
        assert BIG_ROW in data["k"]
    finally:
        holder.close()
    empty = [g for g in _groups(data, ["f", "g"], agg=("Min", "sparse"))
             if g[2] is None]
    assert empty and min(v for v in data["amount"][0]) < 0


@pytest.mark.parametrize("field", ["f", "k"])
def test_fragment_rows_equal(index, field):
    """``row_ids`` and the ``rows_contain`` probe of each fragment as the
    JAX package reads them (its ``rows_containing``)."""
    root, _ = index
    jh, th = JHolder(root).open(), THolder(root).open()
    try:
        jv = jh.index("i").field(field).standard_view()
        tv = th.index("i").field(field).standard_view()
        for s in range(SHARDS):
            jf, tf = jv.fragment(s), tv.fragment(s)
            assert tf.row_ids() == jf.row_ids()
            ids = np.asarray(tf.row_ids(), np.uint64)

            def containing(col):
                return ids[tf.rows_contain(ids, [col])[:, 0]]

            for col in (0, 7, 11, 4095, 77777, SW - 1):
                np.testing.assert_array_equal(containing(col),
                                              jf.rows_containing(col))
            # a written column of each row
            for r in jf.row_ids():
                col = int(jf.row(r).columns()[0]) % SW
                np.testing.assert_array_equal(containing(col),
                                              jf.rows_containing(col))
    finally:
        th.close()
        jh.close()


def test_blocked_matches_unblocked(index, jax_answers, monkeypatch):
    """One combination per block: the same answers, and limit= stops the
    stream early."""
    holder, api = _port_api(index[0], "default")
    calls = []
    real = tgb.groupby_out
    monkeypatch.setattr(tgb, "groupby_out",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    try:
        monkeypatch.setattr(tgb, "BLOCK_OUT_BYTES", 1)
        for pql in ("GroupBy(Rows(f), Rows(g), aggregate=Sum(field=amount))",
                    "GroupBy(Rows(f), Rows(g), Rows(h))",
                    "GroupBy(Rows(f), Rows(g), previous=[1, 0], limit=4)"):
            calls.clear()
            assert api.query("i", pql)["results"] == jax_answers[pql], pql
        assert len(calls) <= 3  # the limit stopped after 4 groups
        calls.clear()
        api.query("i", "GroupBy(Rows(f), Rows(g))")
        assert len(calls) == 6  # one block per combination of f
    finally:
        api.executor.close()
        holder.close()


def test_max_shards_refused(index, monkeypatch):
    holder, api = _port_api(index[0], "off")
    monkeypatch.setattr(tgb, "MAX_SHARDS", SHARDS - 1)
    try:
        with pytest.raises(ExecutionError, match="shards"):
            api.executor.execute("i", "GroupBy(Rows(f))")
    finally:
        holder.close()


def test_group_sums_past_the_int64_bound():
    """Deep fields with huge groups finish Sum in Python ints."""
    rng = np.random.default_rng(3)
    depth = 62
    pos = rng.integers(0, 1 << 20, (2, 3, depth)).astype(np.int32)
    neg = rng.integers(0, 1 << 20, (2, 3, depth)).astype(np.int32)
    cnt = rng.integers(0, 1 << 20, (2, 3)).astype(np.int32)
    out = {"pos": pos, "neg": neg, "cnt": cnt}
    slots = np.array([2, 0])
    got = TExecutor._group_sums(out, slots, base=-7)
    assert got.dtype == object
    for c in range(2):
        for li, s in enumerate(slots):
            want = sum((int(pos[c, s, b]) - int(neg[c, s, b])) << b
                       for b in range(depth)) - 7 * int(cnt[c, s])
            assert got[c, li] == want


# ---------------------------------------------------------------------------
# groupby_out against the JAX package's on the same planes
# ---------------------------------------------------------------------------


def _bits(rng, shape):
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint32)
            & rng.integers(0, 1 << 32, shape, dtype=np.uint32))


def _overlays(plane: np.ndarray, seed: int, n_cols: int):
    """The same rewritten word columns of ``plane`` as the port's and the
    JAX package's BSI overlays."""
    rng = np.random.default_rng(seed)
    s, rows, w = plane.shape
    new, _, _ = make_plane(seed + 1, s, rows - 2, w=w)
    cells = {}
    for c in rng.choice(s * w, n_cols, replace=False):
        sh, wd = divmod(int(c), w)
        for r in range(rows):
            if r == 0 or rng.random() < 0.7:
                cells[(sh * rows + r, wd)] = int(new[sh, r, wd])
    tm, jm = DeltaMirror(1 << 16), JMirror(1 << 16)
    tm.absorb(cells)
    jm.absorb(cells)
    jov = jm.build_bsi_overlay(jnp.asarray, rows, s)
    return (tm.build_bsi_overlay("cpu", rows, s),
            (jov.col_shard, jov.col_word, jov.col_vals, jov.col_mask))


@pytest.mark.parametrize("n_prefix", [0, 1, 2])
@pytest.mark.parametrize("agg", [None, "sum", "minmax"])
@pytest.mark.parametrize("with_delta", [False, True])
def test_groupby_out_equals_jax(n_prefix, agg, with_delta):
    rng = np.random.default_rng(10 * n_prefix + 3 * with_delta
                                + {None: 0, "sum": 1, "minmax": 2}[agg])
    s, w = 3, 64
    prefix = [_bits(rng, (s, n, w)) for n in (4, 2)[:n_prefix]]
    last = _bits(rng, (s, 4, w))
    last[:, 3] = 0  # a pad row
    filt = _bits(rng, (s, w)) | _bits(rng, (s, w))
    combos = tgb.combo_grid([np.arange(3, dtype=np.int32),
                             np.arange(2, dtype=np.int32)][:n_prefix])
    combos = combos.astype(np.int32)
    plane, _, _ = make_plane(int(rng.integers(100)), s, 9, w=w)
    tov = jov = None
    if with_delta:
        tov, jov = _overlays(plane, 5, 5)
    use_plane = agg is not None
    want = jgb.groupby_out(
        tuple(jnp.asarray(p) for p in prefix), jnp.asarray(combos),
        jnp.asarray(last), jnp.asarray(filt),
        jnp.asarray(plane) if use_plane else None, agg,
        agg_delta=jov if use_plane else None)
    got = tgb.groupby_out(
        tuple(port(p) for p in prefix), combos, port(last), port(filt),
        port(plane) if use_plane else None, agg,
        agg_delta=tov if use_plane else None)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# ingest: rows planes refresh, aggregates over the BSI overlay
# ---------------------------------------------------------------------------


GB_SET = ("GroupBy(Rows(f, limit=2), Rows(g))", "GroupBy(Rows(f), Rows(g))",
          "GroupBy(Rows(f, previous=3), Rows(h), aggregate=Sum(field=amount))")


def _cold(root: str, queries) -> dict:
    """Answers of a fresh port executor (planes built from the files)."""
    holder, api = _port_api(root, "off")
    try:
        return {q: api.query("i", q)["results"] for q in queries}
    finally:
        holder.close()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_set_import_refreshes_rows_planes(index, tmp_path, monkeypatch,
                                          config):
    """A set import touching rows inside and outside the selections: the
    resident rows planes take their own rows' cells from the journals (no
    rebuild) and answer as planes built afresh; past MAX_INCR_CELLS the
    next GroupBy rebuilds."""
    root = str(tmp_path / "d")
    shutil.copytree(index[0], root)
    holder, api = _port_api(root, config)
    planes = api.executor.planes
    rng = np.random.default_rng(5)
    try:
        for q in GB_SET:
            api.query("i", q)
        builds, refreshed = planes.builds, planes.incremental_applied
        rows, cols = _pairs(rng, 6, 300)
        assert set(rows.tolist()) >= {0, 1, 4, 5}
        api.import_bits("i", "f", row_ids=rows.tolist(),
                        col_ids=cols.tolist())
        got = {q: api.query("i", q)["results"] for q in GB_SET}
        assert planes.builds == builds
        assert planes.incremental_applied > refreshed
        assert got == _cold(root, GB_SET)
        monkeypatch.setattr(PlaneCache, "MAX_INCR_CELLS", 4)
        rows, cols = _pairs(rng, 6, 300)
        api.import_bits("i", "f", row_ids=rows.tolist(),
                        col_ids=cols.tolist())
        got = api.query("i", GB_SET[1])["results"]
        assert planes.builds == builds + 1
        assert got == _cold(root, GB_SET[1:2])[GB_SET[1]]
    finally:
        api.executor.close()
        holder.close()


GB_AGG = ("GroupBy(Rows(f), aggregate=Sum(field=amount))",
          "GroupBy(Rows(f), Rows(g), aggregate=Min(field=amount))",
          "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_import_values_then_groupby_over_overlay(index, tmp_path, config):
    """importValue into columns of three words (a four-lane overlay with a
    pad lane): GroupBy Sum/Min/Max answer over the resident bit plane
    plus its overlay, no rebuild, as a plane built afresh."""
    root = str(tmp_path / "d")
    shutil.copytree(index[0], root)
    holder, api = _port_api(root, config, delta_compact_fraction=1.0)
    planes = api.executor.planes
    field = holder.index("i").field("amount")
    try:
        for q in GB_AGG:
            api.query("i", q)
        builds = planes.builds
        cols = [7, SW + 300, 2 * SW + 5000]
        api.import_values("i", "amount", col_ids=cols,
                          values=[-4999, 4999, 17])
        got = {q: api.query("i", q)["results"] for q in GB_AGG}
        ov = planes.bsi_plane_delta("i", field, tuple(range(SHARDS))).delta
        assert ov is not None and ov.n == 3 and ov.col_shard.shape[0] == 4
        assert planes.builds == builds
        assert got == _cold(root, GB_AGG)
    finally:
        api.executor.close()
        holder.close()


# ---------------------------------------------------------------------------
# the groupby batcher kind
# ---------------------------------------------------------------------------


def test_identical_groupbys_dedupe(index, jax_answers, monkeypatch):
    """Concurrent identical GroupBys over the same planes share one call
    per window; GroupBys with different filters do not share one."""
    holder, api = _port_api(index[0], "default", count_batch_window=0.05)
    ex = api.executor
    calls = []
    real = ex.fused.run_groupby_batch
    monkeypatch.setattr(ex.fused, "run_groupby_batch",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    same = "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=amount))"
    mixed = ["GroupBy(Rows(f), filter=Row(g=1))",
             "GroupBy(Rows(f), Rows(g), filter=Row(amount > 0))"]
    errors = []

    def client(k, pql=None):
        q = pql or mixed[k % 2]
        try:
            got = api.query("i", q)["results"]
            if got != jax_answers[q]:
                errors.append((q, got))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        api.query("i", same)   # planes resident
        calls.clear()
        start = threading.Barrier(12, timeout=60)
        _run_threads(lambda k: (start.wait(), client(k, same)), 12)
        n_same = len(calls)
        kinds = ex.serving_stats()["kinds"]
        calls.clear()
        start2 = threading.Barrier(8, timeout=60)
        _run_threads(lambda k: (start2.wait(), client(k)), 8)
    finally:
        ex.close()
        holder.close()
    assert not errors, errors[:3]
    assert 1 <= n_same < 12
    assert kinds["groupby"]["maxItems"] >= 2
    assert kinds["groupby"]["items"] > kinds["groupby"]["groups"]
    assert len(calls) >= 2


def test_failing_groupby_launch_reaches_every_caller(index, jax_answers):
    """A GroupBy group whose launch raises delivers the exception to each
    caller (no per-item fallback), the fast lane raises to its caller,
    and the next window is served."""
    holder, api = _port_api(index[0], "default", count_batch_window=0.05)
    ex = api.executor
    pql = "GroupBy(Rows(f), Rows(g))"
    failing = threading.Event()
    failing.set()
    real = ex.fused.run_groupby_batch
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if failing.is_set():
            raise RuntimeError("launch refused")
        return real(*a, **k)

    ex.fused.run_groupby_batch = flaky
    out: list = [None] * 6
    start = threading.Barrier(6, timeout=60)

    def client(k):
        start.wait()
        try:
            out[k] = ex.execute("i", pql)
        except Exception as e:  # noqa: BLE001 — checked below
            out[k] = e

    try:
        _run_threads(client, 6)
        assert all(isinstance(g, RuntimeError) and "launch refused"
                   in str(g) for g in out), out
        assert len(calls) < 6
        failing.clear()
        assert api.query("i", pql)["results"] == jax_answers[pql]
    finally:
        ex.close()
        holder.close()
    holder, api = _port_api(index[0], "default")
    ex = api.executor
    calls.clear()

    def refuse(*a, **k):
        calls.append(1)
        raise RuntimeError("launch refused")

    ex.fused.run_groupby_batch = refuse
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            ex.execute("i", pql)
        assert len(calls) == 1
    finally:
        ex.close()
        holder.close()


@pytest.mark.parametrize("k,n", [(1, 1), (1, 3), (2, 3), (8, 5)])
def test_mini_rows_contiguous(k, n):
    """The mini plane repeated per innermost row is contiguous at every K
    (a reshaped ``expand`` stayed a stride-0 view for K = 1, which the
    card's ``row_counts`` refused after a single value write) and holds
    row ``j`` of the mini plane at rows ``j * n .. j * n + n - 1``."""
    mini = torch.arange(k * 22, dtype=torch.int32).reshape(k, 22, 1)
    got = tgb._mini_rows(mini, n)
    assert got.is_contiguous() and got.shape == (k * n, 22, 1)
    for j in range(k):
        for i in range(n):
            assert torch.equal(got[j * n + i], mini[j])
