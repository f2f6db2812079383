"""Time ranges under a placement, against ``pilosa_tpu``'s meshed executor
on the CPU.

The index of ``tests/test_torch_timeviews.py`` (a YMD time field ``t``
and a set field ``f`` over 3 shards, so every placement pads) and every
time shape sent there: solo ranges, legacy ``Range``, ranges inside
compound trees, ``Rows`` / GroupBy ``from=`` / ``to=``, a time-filtered
TopN, and ``Shift`` / ``Limit`` / ``ConstRow`` / ``UnionRows`` with their
errors.  The port answers over 1, 2, 4 and 8 blocks and 2x4, in both
executor configurations, as the reference's meshed executor answers over
its 8 devices (1-D, and 2x4 for 2x4), bit for bit; then:

- the span path (a budget the time plane exceeds) under a placement,
  with its ``rangesServed`` counters;
- the blocked time plane's bytes per device in ``time_status()``;
- a timestamped write into an existing bucket absorbed into the blocked
  overlay with no rebuild, then a write into a new bucket that rebuilds.
"""

import json
import shutil
import types

import jax
import pytest

from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.result import result_to_json as jjson
from pilosa_tpu.parallel import MeshPlacement as JMesh
from pilosa_tpu.parallel import MeshPlacement2D as JMesh2D
from pilosa_tpu.store import FieldOptions as JFO
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as tjson
from pilosa_tpu_torch.parallel import MeshPlacement2D
from pilosa_tpu_torch.parallel.mesh import Blocked
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads
from pilosa_tpu_torch.virtmesh import virtual_placement
from test_torch_timeviews import (RANGE_SHAPES, ROWS_SHAPES, SPAN_BUDGET,
                                  STATIC_SHAPES, SW, WINDOW, _window_bits,
                                  _write, ts)

share_cpu_threads()

CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}
PLACEMENTS = ["1", "2", "4", "8", "2x4"]
SHAPES = RANGE_SHAPES + ROWS_SHAPES + STATIC_SHAPES
PROBES = [WINDOW, f"Count(Row(t=1, from={ts(0)}))",
          "Count(Row(t=1, from=2021-03-01T00:00))"]


def _answer(ex, to_json, pql: str):
    try:
        return json.loads(json.dumps([to_json(r) for r in
                                      ex.execute("i", pql)]))
    except Exception as e:  # noqa: BLE001 — compared between packages
        return ["error", str(e)]


def _jmesh(name: str):
    if name == "2x4":
        return JMesh2D(jax.devices(), shard_size=2, words_size=4)
    return JMesh(jax.devices())


def _placement(name: str):
    if name == "2x4":
        return MeshPlacement2D(["cpu"] * 8, shard_size=2, words_size=4)
    return virtual_placement(int(name), "cpu")


def _ref(name: str) -> str:
    return "2x4" if name == "2x4" else "1d"


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """``(data dir, {"1d"|"2x4": the reference's meshed answers})``."""
    root = str(tmp_path_factory.mktemp("mesh_time") / "data")
    _write(JHolder, JFO, root).close()
    want = {}
    for name in ("1d", "2x4"):
        d = str(tmp_path_factory.mktemp("ref"))
        shutil.copytree(root, d, dirs_exist_ok=True)
        jh = JHolder(d).open()
        jex = JExecutor(jh, placement=_jmesh(name), **CONFIGS["off"])
        want[name] = {pql: _answer(jex, jjson, pql) for pql in SHAPES}
        jex.translate.close()
        jh.close()
    return root, want


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_time_shapes_equal_the_reference_mesh(index, tmp_path, placement,
                                              config):
    root, want = index
    d = str(tmp_path / "t")
    shutil.copytree(root, d)
    h = THolder(d).open()
    ex = TExecutor(h, placement=_placement(placement), **CONFIGS[config])
    try:
        ref = want[_ref(placement)]
        got = {pql: _answer(ex, tjson, pql) for pql in SHAPES}
        bad = [pql for pql in SHAPES if got[pql] != ref[pql]]
        assert not bad, [(p, got[p], ref[p]) for p in bad[:3]]
        served = ex.time_status()["rangesServed"]
        assert served["plane"] > 0 and served["span"] == 0
        (tp,) = ex.time_status()["planes"]
        assert isinstance(ex.planes._entries[
            ("tplane", "i", "t", ex._shards_for(h.index("i"), None))][1]
            .plane, Blocked)
        assert tp["perDeviceBytes"] == {"cpu": tp["bytes"]}
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("placement", ["4", "2x4"])
def test_span_path_under_a_placement(index, tmp_path, placement):
    """A budget the time plane exceeds: every range unions the cover
    views' blocked rows, with the reference's answers."""
    root, want = index
    d = str(tmp_path / "t")
    shutil.copytree(root, d)
    h = THolder(d).open()
    ex = TExecutor(h, placement=_placement(placement),
                   plane_budget=SPAN_BUDGET)
    try:
        ref = want[_ref(placement)]
        for pql in RANGE_SHAPES:
            assert _answer(ex, tjson, pql) == ref[pql], pql
        served = ex.time_status()["rangesServed"]
        assert served["span"] > 0 and served["plane"] == 0
        assert ex.time_status()["planes"] == []
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("placement", ["4", "2x4"])
def test_writes_absorb_then_a_new_bucket_rebuilds(tmp_path, placement,
                                                  config):
    """A timestamped write into an existing bucket of an existing row
    absorbs into the blocked overlay (one part per block) with no build;
    a write into a new calendar bucket rebuilds; every answer is the
    reference's meshed executor's after the same writes."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _write(JHolder, JFO, jdir, seed=21, n=300).close()
    shutil.copytree(jdir, tdir)
    jh, th = JHolder(jdir).open(), THolder(tdir).open()
    jex = JExecutor(jh, placement=_jmesh(placement), **CONFIGS[config])
    tex = TExecutor(th, placement=_placement(placement), **CONFIGS[config])

    def both(pql):
        want = _answer(jex, jjson, pql)
        assert _answer(tex, tjson, pql) == want, pql
        return want

    try:
        planes = tex.planes
        both(WINDOW)
        builds, absorbs = planes.builds, planes.delta_absorbs
        held = _window_bits(types.SimpleNamespace(holder=th), 1)
        lone = min(c for c, vs in held.items() if len(vs) == 1)
        col = max(held) + 1
        day = held[max(held)][0][len("standard_"):]
        for pql in (f"Clear({lone}, t=1)",
                    f"Set({col}, t=1, {day[:4]}-{day[4:6]}-{day[6:]}T05:00)"):
            both(pql)
            got = both(WINDOW)
        assert lone not in got[1]["columns"] and col in got[1]["columns"]
        assert planes.builds == builds
        assert planes.delta_absorbs == absorbs + 2
        (tp,) = tex.time_status()["planes"]
        assert tp["delta"] is True
        key = ("tplane", "i", "t", tex._shards_for(th.index("i"), None))
        assert len(planes._entries[key][1].delta.parts) == \
            len(planes._entries[key][1].plane.blocks)
        both(f"Set({SW + 5}, t=1, 2021-03-20T00:00)")   # a new bucket
        for pql in PROBES:
            both(pql)
        assert planes.builds > builds
    finally:
        tex.close()
        jex.translate.close()
        jh.close()
        th.close()
