"""Limit, Shift and Extract under a placement, against ``pilosa_tpu``'s
meshed executor on the CPU.

The reference answers every one of these calls over its 8-device virtual
CPU mesh, 1-D ``MeshPlacement`` and 2-D ``MeshPlacement2D`` (2 shard
blocks x 4 word blocks); the port answers them over ``virtual_placement(n,
"cpu")`` for 1, 2, 4 and 8 blocks and over ``MeshPlacement2D(["cpu"] * 8,
2, 4)``, in both executor configurations, bit for bit (tolerance 0).  The
index has 12 shards, so every placement pads, and its field ``f`` has 4
or 8 rows: the row count decides how a ``Row`` is served (a row of the
whole plane, or a gathered rows plane), so both are swept.  The reference
answers in its one-request-at-a-time configuration (its tree path ranks
a ``Limit`` over 32 lanes per word, seconds per call on the CPU mesh);
its answers do not depend on the configuration.  Min/Max are in
``tests/test_torch_mesh_minmax.py``, time ranges in
``tests/test_torch_mesh_time.py``.

- the two faults of the first meshed executor: ``Limit`` ranked per block
  (1-D and 2-D) and ``Shift`` losing its carry between word blocks;
- ``Limit`` windows that start and end in different blocks, inside trees
  and over a shifted child; ``Shift`` by less than, exactly and more than
  a word block's width (8192 words);
- ``Extract`` of a set, a BSI and a keyed field, and the cap's error.
"""

import json
import shutil

import jax
import numpy as np
import pytest

from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.result import result_to_json as jjson
from pilosa_tpu.parallel import MeshPlacement as JMesh
from pilosa_tpu.parallel import MeshPlacement2D as JMesh2D
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as tjson
from pilosa_tpu_torch.parallel import MeshPlacement2D
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads
from pilosa_tpu_torch.virtmesh import virtual_placement

share_cpu_threads()

N_SHARDS = 12
N_COLS = 4000
N_VALUED = 1500
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}
# a 2x4 placement's word block: 8192 words, 262144 columns
WORD_BLOCK_COLS = SHARD_WIDTH // 4

LIMITS = [
    "Count(Limit(Row(f=1), limit=3))",
    "Count(Limit(Row(f=1), limit=300, offset=200))",
    "Limit(Row(f=1), limit=5)",
    "Limit(Row(f=1), limit=400, offset=150)",
    "Limit(Union(Row(f=0), Row(f=2)), offset=700)",
    "Count(Intersect(Row(g=1), Limit(Row(f=1), limit=500, offset=100)))",
    "Count(Limit(Row(f=3), offset=100000))",
    "Limit(Row(f=1), limit=0)",
    f"Count(Limit(Shift(Row(f=1), n={WORD_BLOCK_COLS + 7}), limit=250, "
    "offset=20))",
]
SHIFTS = [
    "Count(Shift(Row(f=1), n=40000))",
    "Count(Shift(Row(f=1), n=5))",
    f"Count(Shift(Row(f=2), n={WORD_BLOCK_COLS}))",
    f"Count(Shift(Row(f=2), n={WORD_BLOCK_COLS + 31}))",
    f"Shift(Row(f=1), n={2 * WORD_BLOCK_COLS + 77})",
    f"Count(Intersect(Row(g=1), Shift(Row(f=1), n={WORD_BLOCK_COLS - 1})))",
    "Count(Shift(Shift(Row(f=3), n=131072), n=131073))",
]
EXTRACTS = [
    "Extract(Limit(Row(f=1), limit=5), Rows(f))",
    "Extract(Limit(Row(f=1), limit=40, offset=300), Rows(g), Rows(amount), "
    "Rows(k))",
    "Extract(Row(f=99), Rows(f))",
    'Extract(Intersect(Row(g=1), Row(k="red")), Rows(f), Rows(amount), '
    "Rows(k))",
]
CALLS = LIMITS + SHIFTS + EXTRACTS + ["".join(LIMITS[:2] + SHIFTS[:2])]
PLACEMENTS = ["1", "2", "4", "8", "2x4"]
KEYED = {"red": 25, "blue": 40}  # key -> every n-th selected column


def _write(root: str, n_rows: int) -> None:
    """Index ``i`` through ``pilosa_tpu``: ``f`` with ``n_rows`` rows over
    4000 random columns, ``g`` row 1 over half of them, ``amount`` over
    the first 1500 and the keyed field ``k``."""
    rng = np.random.default_rng(1)
    h = JHolder(root).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        idx.create_field(name)
    idx.create_field("amount", JFO(type="int", min=-200, max=200))
    idx.create_field("k", JFO(keys=True))
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, N_COLS,
                      replace=False).astype(np.uint64)
    idx.field("f").import_bits(
        rng.integers(0, n_rows, N_COLS).astype(np.uint64), cols)
    half = cols[:N_COLS // 2]
    idx.field("g").import_bits(np.ones(len(half), np.uint64), half)
    idx.field("amount").import_values(cols[:N_VALUED],
                                      rng.integers(-120, 120, N_VALUED))
    idx.note_columns(cols)
    ex = JExecutor(h)
    ex.execute("i", "".join(f'Set({int(c)}, k="{key}")'
                            for key, step in KEYED.items()
                            for c in np.sort(cols)[::step]))
    ex.translate.close()
    h.close()


def _answer(ex, to_json, pql: str):
    try:
        return json.loads(json.dumps([to_json(r) for r in
                                      ex.execute("i", pql)]))
    except Exception as e:  # noqa: BLE001 — compared between executors
        return ["error", type(e).__name__, str(e)]


def _jmesh(name: str):
    if name == "2x4":
        return JMesh2D(jax.devices(), shard_size=2, words_size=4)
    return JMesh(jax.devices())


def _placement(name: str):
    if name == "2x4":
        return MeshPlacement2D(["cpu"] * 8, shard_size=2, words_size=4)
    return virtual_placement(int(name), "cpu")


def reference_index(root: str, n_rows: int, calls: list, scratch) -> dict:
    """Write the index into ``root`` and answer ``calls`` through the
    reference's meshed executor, 1-D over the 8 devices ("1d") and 2x4
    ("2d"), each over a copy in ``scratch()``; every call answers."""
    _write(root, n_rows)
    want = {}
    for name in ("1d", "2x4"):
        d = scratch()
        shutil.copytree(root, d, dirs_exist_ok=True)
        jh = JHolder(d).open()
        jex = JExecutor(jh, placement=_jmesh(name), **CONFIGS["off"])
        want[name] = {pql: _answer(jex, jjson, pql) for pql in calls}
        jex.translate.close()
        jh.close()
        assert not [p for p, a in want[name].items() if a[0] == "error"]
    return want


def sweep(root: str, want: dict, calls: list, d: str, placement: str,
          config: str) -> None:
    """The port over ``placement`` in ``config`` answers ``calls`` on a
    copy of ``root`` in ``d`` as the reference's meshed executor does."""
    shutil.copytree(root, d)
    h = THolder(d).open()
    ex = TExecutor(h, placement=_placement(placement), **CONFIGS[config])
    try:
        ref = want["2x4" if placement == "2x4" else "1d"]
        got = {pql: _answer(ex, tjson, pql) for pql in calls}
        bad = [pql for pql in calls if got[pql] != ref[pql]]
        assert not bad, [(p, got[p], ref[p]) for p in bad[:3]]
    finally:
        ex.close()
        h.close()


@pytest.fixture(scope="module", params=[4, 8], ids=lambda n: f"{n}rows")
def index(request, tmp_path_factory):
    """``(data dir, {"1d"|"2x4": the reference's meshed answers})``."""
    root = str(tmp_path_factory.mktemp(f"calls{request.param}"))
    return root, reference_index(
        root, request.param, CALLS,
        lambda: str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_calls_equal_the_reference_mesh(index, tmp_path, placement, config):
    sweep(*index, CALLS, str(tmp_path / "t"), placement, config)


@pytest.mark.parametrize("placement", ["2", "2x4"])
def test_limit_ranked_globally(index, tmp_path, placement):
    """The first meshed executor ranked a ``Limit`` per block: on 4 rows
    ``Count(Limit(Row(f=1), limit=3))`` answered 6 over two blocks and 24
    over 2x4 blocks, and the 200-offset window 584 and 0, where the
    reference answers 3 and 300."""
    root, want = index
    d = str(tmp_path / "t")
    shutil.copytree(root, d)
    h = THolder(d).open()
    ex = TExecutor(h, placement=_placement(placement))
    try:
        for pql in LIMITS[:2]:
            assert _answer(ex, tjson, pql) == want["1d"][pql]
        (n,) = ex.execute("i", "Count(Row(f=1))")
        assert ex.execute("i", LIMITS[0]) == [3]
        assert ex.execute("i", LIMITS[1]) == [min(300, n - 200)]
        (row,) = ex.execute("i", "Limit(Row(f=1), limit=3)")
        assert len(row.columns) == 3
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("placement", ["4", "2x4"])
def test_extract_cap_under_a_placement(index, tmp_path, placement):
    """The cap holds on the blocks' gathered counts before anything is
    read: the same error text as the reference's meshed executor."""
    root, _ = index
    dirs = [str(tmp_path / n) for n in ("j", "t")]
    for d in dirs:
        shutil.copytree(root, d)
    jh, th = JHolder(dirs[0]).open(), THolder(dirs[1]).open()
    jex = JExecutor(jh, placement=_jmesh(placement), **CONFIGS["off"])
    tex = TExecutor(th, placement=_placement(placement))
    try:
        for ex in (jex, tex):
            ex.MAX_EXTRACT_COLUMNS = 300
        for pql in ("Extract(Row(f=1), Rows(g))",
                    "Extract(Limit(Row(f=1), limit=300), Rows(amount))"):
            want = _answer(jex, jjson, pql)
            assert _answer(tex, tjson, pql) == want, pql
        assert "cap is 300" in _answer(tex, tjson, "Extract(Row(f=1), "
                                                   "Rows(g))")[2]
    finally:
        tex.close()
        jex.translate.close()
        jh.close()
        th.close()
