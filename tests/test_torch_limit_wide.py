"""``Limit`` past 2047 shards with no placement, against the JAX package.

The port once refused ``Limit`` over more than 2047 shards without a
placement (the int32 bound of its cross-shard sums); the reference
answers it by paging the columns on the host.  The port's ranks start
from int64 per-shard bases (``engine.kernels.rank_limit``), so it answers
over any number of shards.  The same numpy-made data go through
``pilosa_tpu`` and ``pilosa_tpu_torch`` on the CPU:

- an index of 2050 shards (field ``e`` holds one bit in every shard),
  where row 1 of ``f`` has three bits in each of shards 0, 2046, 2047 and
  2049: ``Limit`` as a bitmap, under ``Count`` and inside a compound
  tree, with windows that start below shard 2047 and end above it, in
  both executor configurations;
- the same row in an index that holds only those four shards (columns
  past 2^31, quick to serve), over more calls and windows, ``Extract``
  and bounds past 2^63 among them;
- ``rank_limit`` and a ``TREE_LIMIT`` tree against a numpy oracle of the
  set bits at 2050 shards of a narrow word axis, and ``_rank_window``
  with bases past 2^31 and 2^32.
"""

import json
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.parallel.mesh import shard_prefix
from pilosa_tpu_torch.store import Holder as THolder
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = 1 << 20
WIDE = 2050                      # shards: past the old 2047 bound
ROW_SHARDS = (0, 2046, 2047, 2049)
OFFSETS = (5, 100, 70000)        # row 1's bits in each of ROW_SHARDS
CONFIGS = {"off": {"count_batch_window": "off", "tree_fusion": False},
           "default": {}}

# ranks 0-2 lie in shard 0, 3-5 in 2046, 6-8 in 2047 and 9-11 in 2049;
# row 2 holds every other bit of row 1
WIDE_CALLS = (
    "Limit(Row(f=1), limit=5, offset=2)",
    "Count(Limit(Row(f=1), limit=6, offset=4))"
    "Count(Intersect(Row(f=2), Limit(Row(f=1), offset=5)))",
)
SPARSE_CALLS = WIDE_CALLS + (
    "Limit(Row(f=1), offset=4)",
    "Limit(Row(f=1), limit=3, offset=5)",
    "Limit(Row(f=1), limit=1, offset=11)",
    "Limit(Row(f=1), offset=12)",
    "Count(Limit(Row(f=1), offset=7))",
    "Count(Union(Row(f=2), Limit(Row(f=1), limit=2, offset=5)))",
    "Count(Difference(Limit(Row(f=1), limit=7, offset=3), Row(f=2)))",
    "Extract(Limit(Row(f=1), limit=4, offset=3), Rows(f))",
    "Limit(Row(f=1), limit=9223372036854775807, offset=3)",
    "Limit(Row(f=1), offset=99999999999999999999)",
    "Count(Limit(Row(f=1), limit=99999999999999999999, offset=8))",
)


def _write(root: str, wide: bool) -> None:
    """Index ``i``: row 1 of ``f`` with ``OFFSETS`` in each of
    ``ROW_SHARDS``, row 2 every other of those bits; with ``wide``, field
    ``e`` holds one bit in each of ``WIDE`` shards."""
    h = JHolder(root).open()
    idx = h.create_index("i")
    idx.create_field("f")
    cols = np.array([s * SW + o for s in ROW_SHARDS for o in OFFSETS],
                    np.uint64)
    f = idx.field("f")
    f.import_bits(np.ones(len(cols), np.uint64), cols)
    f.import_bits(np.full(len(cols[::2]), 2, np.uint64), cols[::2])
    if wide:
        idx.create_field("e")
        idx.field("e").import_bits(np.zeros(WIDE, np.uint64),
                                   np.arange(WIDE, dtype=np.uint64) * SW + 3)
    h.close()


def _answer(api, pql: str):
    try:
        return api.query("i", pql)["results"]
    except Exception as e:  # noqa: BLE001 — compared between packages
        return ("error", str(e))


def _reference(root: str, calls) -> dict:
    """The JAX executor's answers, its holder closed after them."""
    os.environ["PILOSA_PALLAS_INTERPRET"] = "1"
    holder = JHolder(root).open()
    try:
        api = JAPI(holder, JExecutor(holder, plane_paging=False,
                                     kernel_tier="pallas",
                                     **CONFIGS["off"]))
        return {q: json.dumps(_answer(api, q)) for q in calls}
    finally:
        holder.close()


def _port(root: str, config: str):
    holder = THolder(root).open()
    return holder, TAPI(holder, TExecutor(holder, device="cpu",
                                          **CONFIGS[config]))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("limit_wide") / "data")
    _write(root, wide=True)
    return root, _reference(root, WIDE_CALLS)


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("limit_sparse") / "data")
    _write(root, wide=False)
    return root, _reference(root, SPARSE_CALLS)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_limit_over_2050_shards_equal(wide, config):
    """The index spans 2050 shards: every call answers as the reference
    (no refusal), windows crossing shard 2047."""
    root, want = wide
    holder, api = _port(root, config)
    try:
        assert len(holder.index("i").available_shards()) == WIDE
        for q in WIDE_CALLS:
            got = json.dumps(_answer(api, q))
            assert got == want[q], q
            assert "error" not in got, got
    finally:
        api.executor.close()
        holder.close()


@pytest.fixture(scope="module", params=list(CONFIGS))
def sparse_api(sparse, request):
    holder, api = _port(sparse[0], request.param)
    yield api, sparse[1]
    api.executor.close()
    holder.close()


@pytest.mark.parametrize("pql", SPARSE_CALLS)
def test_limit_past_2_31_columns_equal(sparse_api, pql):
    """Shards 0, 2046, 2047 and 2049 only: columns past 2^31, bounds past
    2^63 (the port once raised OverflowError where the reference answers
    an empty bitmap)."""
    api, want = sparse_api
    assert json.dumps(_answer(api, pql)) == want[pql], pql


def _oracle_limit(words: np.ndarray, offset: int, limit: int) -> np.ndarray:
    """numpy: the set bits of ``words`` uint32[S, W] in global order,
    those ranked ``[offset, offset + limit)`` kept."""
    flat = words.reshape(-1)
    nz = np.flatnonzero(flat)
    bits = np.unpackbits(flat[nz].view(np.uint8).reshape(-1, 4),
                         axis=1, bitorder="little")          # [n, 32]
    word_of, lane = np.nonzero(bits)
    end = None if limit < 0 else offset + limit
    keep = np.zeros(len(word_of), bool)
    keep[offset:end] = True
    out = np.zeros_like(flat)
    np.bitwise_or.at(out, nz[word_of[keep]],
                     np.uint32(1) << lane[keep].astype(np.uint32))
    return out.reshape(words.shape)


def _wide_words(seed: int, n_shards: int = WIDE, w: int = 64) -> np.ndarray:
    """Sparse words over ``n_shards`` shards of ``w`` words: a few set
    bits in every shard, and shards 2046-2049 (where there are) denser."""
    rng = np.random.default_rng(seed)
    words = np.where(rng.random((n_shards, w)) < 0.05,
                     rng.integers(0, 1 << 32, (n_shards, w), dtype=np.uint64),
                     0).astype(np.uint32)
    dense = words[2046:2050]
    dense |= rng.integers(0, 1 << 32, dense.shape,
                          dtype=np.uint64).astype(np.uint32)
    return words


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("offset,limit", [
    (0, -1), (0, 0), (5, 17), (None, 40), (None, -1), (None, 1),
    (10 ** 9, 5)])
def test_rank_limit_2050_shards_matches_oracle(offset, limit):
    """``rank_limit`` over 2050 shards; ``None``: a window starting a few
    bits before shard 2047."""
    words = _wide_words(3)
    if offset is None:
        before = np.bitwise_count(words[:2047]).sum(dtype=np.int64)
        offset = int(before) - 7
    got = tk.rank_limit(_t(words), offset, limit).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _oracle_limit(words, offset, limit))


def test_tree_limit_2050_shards_matches_oracle():
    """A ``TREE_LIMIT`` inside a compound tree (``(a & b) | Limit(a,
    ...)``) over 2050 shards."""
    a, b = _wide_words(4), _wide_words(5)
    before = int(np.bitwise_count(a[:2046]).sum(dtype=np.int64))
    skeleton = (tk.TREE_PUSH, tk.TREE_PUSH, tk.TREE_AND, tk.TREE_PUSH,
                (tk.TREE_LIMIT, (before, 60)), tk.TREE_OR)
    rows = torch.stack([_t(a), _t(b)])
    got = tk.tree_fold(rows, skeleton, [0, 1, 0]).numpy().view(np.uint32)
    want = (a & b) | _oracle_limit(a, before, 60)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [(1 << 31) + 3, (1 << 32) + 11,
                                   (1 << 62) - 1000])
def test_rank_window_bases_past_int32(shift):
    """Each shard's window is clamped in int64 before it is ranked in
    int32: bases and bounds past 2^31 answer as the same window does from
    0."""
    words = _wide_words(6, n_shards=40, w=16)
    t = _t(words)
    counts = tk.count(t)
    base = shard_prefix(counts)
    for offset, end in ((0, 9), (3, 200), (100, 1 << 40), (0, 0)):
        want = tk.rank_limit(t, offset, end - offset)
        got = tk._rank_window(t, base + shift, counts, offset + shift,
                              min(end + shift, 1 << 62))
        assert torch.equal(got, want), (offset, end)
