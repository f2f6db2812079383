"""Min, Max and GroupBy Min/Max under a placement, against
``pilosa_tpu``'s meshed executor on the CPU.

The index and the sweep of ``tests/test_torch_mesh_calls.py`` (12
shards, ``f`` of 4 or 8 rows; 1, 2, 4 and 8 blocks and 2x4, both
executor configurations, bit for bit).  On a 2-D placement the Min/Max
descent sums each step's per-shard counts over the shard's word blocks
before any block moves on (``parallel.mesh.run_steps``), and each block's
entries carry its part of the counts; over an overlay each block's
touched columns descend on their own.

- ``Min`` / ``Max`` plain, filtered and over an empty filter;
- GroupBy Min/Max, with and without a filter;
- values written under a 2-D placement: absorbed into the blocked BSI
  overlay, then the same calls against the unmeshed port.
"""

import shutil

import numpy as np
import pytest

from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.exec import result_to_json as tjson
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads
from test_torch_mesh_calls import (CONFIGS, N_SHARDS, PLACEMENTS, _answer,
                                   _placement, reference_index, sweep)

share_cpu_threads()

MINMAX = [
    "Min(field=amount)", "Max(Row(f=1), field=amount)",
    "Min(Row(f=99), field=amount)",
    "GroupBy(Rows(f), aggregate=Min(field=amount))",
    "GroupBy(Rows(f), filter=Row(g=1), aggregate=Max(field=amount))",
]


@pytest.fixture(scope="module", params=[4, 8], ids=lambda n: f"{n}rows")
def index(request, tmp_path_factory):
    """``(data dir, {"1d"|"2x4": the reference's meshed answers})``."""
    root = str(tmp_path_factory.mktemp(f"minmax{request.param}"))
    return root, reference_index(
        root, request.param, MINMAX,
        lambda: str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_minmax_equal_the_reference_mesh(index, tmp_path, placement,
                                         config):
    sweep(*index, MINMAX, str(tmp_path / "t"), placement, config)


def test_2d_minmax_over_an_overlay(index, tmp_path):
    """Values written under a 2-D placement absorb into the blocked BSI
    overlay (no rebuild); Min/Max and GroupBy Min/Max answer base+delta
    as the unmeshed port does (the default configuration: its batcher's
    ``minmax`` and ``groupby`` kinds)."""
    root, _ = index
    d = str(tmp_path / "t")
    shutil.copytree(root, d)
    h = THolder(d).open()
    plain = TExecutor(h, device="cpu")
    meshed = TExecutor(h, placement=_placement("2x4"))
    try:
        for pql in MINMAX:   # every plane resident before the write
            meshed.execute("i", pql)
        builds = meshed.planes.builds
        rng = np.random.default_rng(2)
        cols = rng.choice(N_SHARDS * SHARD_WIDTH, 40, replace=False)
        vals = rng.integers(-199, 199, 40)
        vals[0], vals[1] = -199, 198        # the new extremes
        h.index("i").field("amount").import_values(
            np.asarray(cols, np.uint64), vals)
        for pql in MINMAX:
            assert _answer(meshed, tjson, pql) == \
                _answer(plain, tjson, pql), pql
        assert meshed.execute("i", "Min(field=amount)")[0].value == -199
        assert meshed.planes.builds == builds
        assert meshed.planes.delta_absorbs > 0
    finally:
        meshed.close()
        plain.close()
        h.close()
