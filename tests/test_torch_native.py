"""The port's native roaring codec (``pilosa_tpu_torch/store/native.py``
over its own copy of the C++ source) against ``pilosa_tpu.store.roaring``
and the port's numpy codec: identical bytes over array, bitmap and run
containers, decodes both ways, expansions equal to the directory's
per-row words, the sorted unions and differences, the wrappers' error
texts, and the build cache keyed by the source's hash."""

import os
import shutil

import numpy as np
import pytest

from pilosa_tpu.engine.words import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu.store import native as jnative
from pilosa_tpu.store import roaring as jroaring
from pilosa_tpu_torch.store import native
from pilosa_tpu_torch.store import roaring as troaring
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SW = np.uint64(SHARD_WIDTH)

CASES = [
    np.array([], np.uint64),
    np.array([0, 1, 5, 100, 65535], np.uint64),                  # array
    np.array([0, 65535, 65536, 65537, 1 << 20, (1 << 20) + 3], np.uint64),
    np.array([1 << 32, (1 << 40) + 7, 1 << 45], np.uint64),
    np.arange(10, 50000, dtype=np.uint64),                       # run
    np.arange(0, 8194, 2, dtype=np.uint64),                      # bitmap edge
    np.arange(0, 65536 * 3, 3, dtype=np.uint64),                 # bitmaps
]


def _mixed(rng) -> np.ndarray:
    """Every container kind across several rows: sparse arrays, dense
    bitmaps, long runs."""
    sparse = rng.choice(3 * SHARD_WIDTH, 4000, replace=False)
    dense = 4 * SHARD_WIDTH + rng.choice(65536, 30000, replace=False)
    runs = np.arange(5 * SHARD_WIDTH + 100, 5 * SHARD_WIDTH + 20000)
    return np.unique(np.concatenate([sparse, dense, runs]).astype(np.uint64))


@pytest.mark.parametrize("positions", CASES, ids=range(len(CASES)))
def test_serialize_bytes_equal(positions):
    want = jroaring.serialize(positions)
    assert native.serialize(positions) == want
    assert troaring.serialize(positions) == want
    assert troaring._serialize_plain(positions) == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serialize_random_mixed_equal(seed):
    pos = _mixed(np.random.default_rng(seed))
    want = jroaring.serialize(pos)
    assert troaring.serialize(pos) == want
    # unsorted input with duplicates serializes as its sorted set
    shuffled = np.random.default_rng(seed).permutation(
        np.concatenate([pos, pos[:100]]))
    assert troaring.serialize(shuffled) == want


def test_cross_decode(rng):
    pos = _mixed(rng)
    jblob = jroaring.serialize(pos)
    tblob = native.serialize(pos)
    np.testing.assert_array_equal(native.deserialize(jblob), pos)
    np.testing.assert_array_equal(troaring.deserialize(jblob), pos)
    np.testing.assert_array_equal(jroaring.deserialize(tblob), pos)
    np.testing.assert_array_equal(troaring._deserialize_plain(tblob), pos)
    # a memoryview (a snapshot's mmap) decodes without a copy
    np.testing.assert_array_equal(native.deserialize(memoryview(jblob)), pos)


def test_random_round_trips(rng):
    for _ in range(5):
        n = int(rng.integers(1, 50000))
        pos = np.unique(rng.integers(0, 1 << 44, size=n, dtype=np.uint64))
        blob = native.serialize(pos)
        assert blob == jroaring.serialize(pos)
        np.testing.assert_array_equal(native.deserialize(blob), pos)


def test_standard32_still_decodes(rng):
    vals = np.unique(rng.integers(0, 1 << 31, 3000)).astype(np.uint64)
    blob = jroaring.write_standard32(vals)
    np.testing.assert_array_equal(troaring.deserialize(blob),
                                  jroaring.deserialize(blob))


def _rows_blob(rng, rows) -> tuple[bytes, dict]:
    expect, parts = {}, []
    for i, r in enumerate(rows):
        if i % 3 == 0:       # array containers
            cols = np.sort(rng.choice(SHARD_WIDTH, 500, replace=False))
        elif i % 3 == 1:     # a bitmap container
            cols = 65536 + np.sort(rng.choice(65536, 9000, replace=False))
        else:                # runs
            cols = np.arange(1000, 40000)
        expect[int(r)] = cols.astype(np.uint64)
        parts.append(np.uint64(r) * SW + cols.astype(np.uint64))
    return jroaring.serialize(np.concatenate(parts)), expect


def test_expand_rows_into_equals_directory_row_words(rng):
    rows = np.array([2, 7, 40, 41, 300], np.uint64)
    blob, _ = _rows_blob(rng, rows)
    d = jroaring.Directory(memoryview(blob))
    want = np.zeros((len(rows), WORDS_PER_SHARD), np.uint32)
    for i, r in enumerate(rows):
        d.row_words(int(r), want[i])
    # scattered slots of a larger plane; the rows not asked for stay 0
    out = np.zeros((9, WORDS_PER_SHARD), np.uint32)
    slots = np.array([8, 0, 3, 5, 1], np.uint64)
    bits = native.expand_rows_into(blob, SHARD_WIDTH, rows, slots, out)
    assert bits == int(np.bitwise_count(want).sum())
    np.testing.assert_array_equal(out[slots.astype(np.intp)], want)
    assert not out[[2, 4, 6, 7]].any()
    # a subset of the rows: the others are skipped
    sub = np.zeros((2, WORDS_PER_SHARD), np.uint32)
    native.expand_rows_into(blob, SHARD_WIDTH, rows[[1, 3]],
                            np.array([1, 0], np.uint64), sub)
    np.testing.assert_array_equal(sub, want[[3, 1]])


def test_expand_plane_equals_directory_row_words(rng):
    rows = np.array([3, 9, 77], np.uint64)
    blob, _ = _rows_blob(rng, rows)
    d = jroaring.Directory(memoryview(blob))
    plane = np.zeros((3, WORDS_PER_SHARD), np.uint32)
    native.expand_plane(blob, SHARD_WIDTH, rows, plane)
    for i, r in enumerate(rows):
        want = np.zeros(WORDS_PER_SHARD, np.uint32)
        d.row_words(int(r), want)
        np.testing.assert_array_equal(plane[i], want)


def test_dense_image_round_trip(rng):
    words = rng.integers(0, 1 << 32, size=(3, WORDS_PER_SHARD),
                         dtype=np.uint32)
    words[1, 4096:8192] = 0  # an all-zero container is left out
    row_ids = np.array([1, 8, 200], np.uint64)
    blob = troaring.serialize_dense(words, row_ids)
    assert blob == jroaring.serialize_dense(words, row_ids)
    out = np.zeros((3, WORDS_PER_SHARD), np.uint32)
    native.expand_rows_into(blob, SHARD_WIDTH, row_ids,
                            np.arange(3, dtype=np.uint64), out)
    np.testing.assert_array_equal(out, words)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_union_and_diff_equal_numpy(seed):
    rng = np.random.default_rng(seed)
    for na, nb in ((0, 0), (0, 50), (50, 0), (1000, 700), (5, 30000)):
        a = np.unique(rng.integers(0, 1 << 20, na)).astype(np.uint32)
        b = np.unique(rng.integers(0, 1 << 20, nb)).astype(np.uint32)
        u = native.union_sorted_u32(a, b)
        assert u.dtype == np.uint32
        np.testing.assert_array_equal(u, np.union1d(a, b))
        np.testing.assert_array_equal(
            native.diff_sorted_u32(a, b),
            np.setdiff1d(a, b, assume_unique=True))
    # other dtypes and strided views convert
    a = np.arange(0, 100, 2, dtype=np.int64)[::2]
    b = np.arange(0, 100, 3, dtype=np.uint64)
    np.testing.assert_array_equal(native.union_sorted_u32(a, b),
                                  np.union1d(a, b).astype(np.uint32))


def _error(fn, *args) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_error_texts_equal_reference():
    blob = jroaring.serialize(np.array([5, SHARD_WIDTH + 5], np.uint64))
    plane = np.zeros((1, WORDS_PER_SHARD), np.uint32)
    one, two = np.array([1], np.uint64), np.array([0, 1], np.uint64)
    # argument checks: the reference's wrappers raise before the library
    for name, args in (
            ("expand_rows_into", (blob, SHARD_WIDTH, one, two, plane)),
            ("expand_rows_into", (blob, SHARD_WIDTH, one, one[:1] * 0,
                                  plane.astype(np.int64))),
            ("expand_rows_into", (blob, SHARD_WIDTH, one, one * 0,
                                  np.zeros(WORDS_PER_SHARD, np.uint32))),
            ("expand_plane", (blob, SHARD_WIDTH, one,
                              np.zeros((2, 8), np.uint32)[:, ::2]))):
        assert _error(getattr(native, name), *args) \
            == _error(getattr(jnative, name), *args)
    # library error codes: the same table and texts
    assert native._ERRORS == jnative._ERRORS
    for rc in (-1, -2, -3, -4, -5, -9):
        assert _error(native._check, rc, "deserialize") \
            == _error(jnative._check, rc, "deserialize")
    assert _error(native.deserialize, b"\x00\x01\x02\x03\x04\x05\x06\x07") \
        == "native codec cardinality: bad magic/version"
    assert _error(native.deserialize, blob[:20]) \
        == "native codec cardinality: truncated buffer"
    # a slot past the plane: an error, never an out-of-bounds write
    assert _error(native.expand_rows_into, blob, SHARD_WIDTH, one, one,
                  plane) == "native codec expand_rows_into: output buffer " \
                            "too small"


def test_rebuild_after_source_changes(tmp_path):
    src = tmp_path / "codec.cpp"
    shutil.copy(native.SOURCE, src)
    out = tmp_path / "build"
    first = native.build(str(src), str(out))
    assert os.path.basename(first).startswith("libroaring_codec_")
    assert native.build(str(src), str(out)) == first  # cached: no rebuild
    mtime = os.stat(first).st_mtime_ns
    with open(src, "a") as f:
        f.write("\n// edited\n")
    second = native.build(str(src), str(out))
    assert second != first and os.path.exists(second)
    assert os.stat(first).st_mtime_ns == mtime
    # the new library loads and serializes the same bytes
    lib = native._bind(second)
    pos = np.array([1, 2, 70000], np.uint64)
    buf = np.empty(256, np.uint8)
    n = lib.rc_serialize(native._p64(pos), 3,
                         buf.ctypes.data_as(native.ctypes.POINTER(
                             native.ctypes.c_uint8)), 256)
    assert buf[:n].tobytes() == jroaring.serialize(pos)


def test_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(bad), str(tmp_path / "b"))
    assert not [f for f in os.listdir(tmp_path / "b")]  # no partial file
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    src = tmp_path / "codec.cpp"
    shutil.copy(native.SOURCE, src)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(str(src), str(tmp_path / "c"))


def test_no_switch_and_no_fallback(monkeypatch):
    """The environment cannot turn the codec off, and the serving paths
    call it: a broken library fails them instead of falling back."""
    monkeypatch.setenv("PILOSA_NO_NATIVE", "1")
    pos = np.array([3, 9], np.uint64)
    assert troaring.serialize(pos) == jroaring.serialize(pos)

    class Broken:
        def __getattr__(self, name):
            raise OSError("codec gone")

    monkeypatch.setattr(native, "_lib", Broken())
    with pytest.raises(OSError):
        troaring.serialize(pos)
    with pytest.raises(OSError):
        troaring.deserialize(jroaring.serialize(pos))
