"""The port's BSI functions (``pilosa_tpu_torch.engine.bsi``) against the
JAX package's (``pilosa_tpu.engine.bsi``) on the same numpy bit planes,
exactly: range compares, the Sum counts, the Min/Max descent, Distinct's
two paths and the Percentile search.  Planes are small (a few shards of a
few hundred words) and made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.engine import bsi as jbsi
from pilosa_tpu_torch.engine import bsi as tbsi
from pilosa_tpu_torch.exec.fused import FusedCache
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

W = 96  # words per shard: 3072 columns


def make_plane(seed: int, shards: int, depth: int, *, fill: float = 0.6,
               signs: str = "mixed", w: int = W):
    """(uint32 plane [S, depth+2, W], int64 values [S, W*32], bool exists)
    with values uniform over +-(2^depth - 1); ``signs`` "neg" / "pos"
    keeps one sign, "mixed" both; the store's layout (no negative
    zero)."""
    rng = np.random.default_rng(seed)
    bound = (1 << depth) - 1
    lo = {"mixed": -bound, "neg": -bound, "pos": 0}[signs]
    hi = {"mixed": bound, "neg": -1, "pos": bound}[signs]
    values = rng.integers(lo, hi + 1, (shards, w * 32))
    exists = rng.random((shards, w * 32)) < fill
    values = np.where(exists, values, 0)
    mag = np.abs(values)

    def pack(bits):
        return np.packbits(bits.astype(np.uint8), axis=-1,
                           bitorder="little").view(np.uint32)

    rows = [pack(exists), pack(exists & (values < 0))]
    rows += [pack(exists & ((mag >> b) & 1).astype(bool))
             for b in range(depth)]
    return np.stack(rows, axis=1), values, exists


def filt(seed: int, shards: int, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (shards, w), dtype=np.uint32)


def port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.numpy()
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.uint32 else a


DEPTH = 9
PLANE, VALUES, EXISTS = make_plane(1, 3, DEPTH)
FILT = filt(2, 3)


@pytest.mark.parametrize("p", [0, 1, 5, 100, 511, -1, -5, -100, -511])
@pytest.mark.parametrize("with_filter", [False, True])
def test_range_cmp_equal(p, with_filter):
    masks = jbsi.predicate_masks(abs(p), DEPTH)
    f = FILT if with_filter else None
    want = jbsi.range_cmp(jnp.asarray(PLANE), jnp.asarray(masks),
                          jnp.asarray(p < 0),
                          None if f is None else jnp.asarray(f))
    got = tbsi.range_cmp(port(PLANE), tbsi.predicate_masks(abs(p), DEPTH),
                         p < 0, None if f is None else port(f))
    assert set(got) == set(want) == set(tbsi.CMP_KEYS)
    for key in tbsi.CMP_KEYS:
        assert np.array_equal(host(got[key]), host(want[key])), key
    # device-form predicates (Percentile's) give the same bitmaps
    dev_masks = port(tbsi.predicate_masks(abs(p), DEPTH))
    dev = tbsi.range_cmp(port(PLANE), dev_masks, torch.tensor(p < 0),
                         None if f is None else port(f))
    for key in tbsi.CMP_KEYS:
        assert torch.equal(dev[key], got[key]), key
    # and against the numpy oracle
    ok = EXISTS if f is None else EXISTS & np.unpackbits(
        f.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    oracle = {"lt": VALUES < p, "le": VALUES <= p, "gt": VALUES > p,
              "ge": VALUES >= p, "eq": VALUES == p, "ne": VALUES != p}
    for key, want_cols in oracle.items():
        bits = np.unpackbits(host(got[key]).view(np.uint8), axis=-1,
                             bitorder="little").astype(bool)
        assert np.array_equal(bits, want_cols & ok), key


def test_range_cmp_keys_subset():
    masks = tbsi.predicate_masks(37, DEPTH)
    full = tbsi.range_cmp(port(PLANE), masks, True)
    for key in tbsi.CMP_KEYS:
        one = tbsi.range_cmp(port(PLANE), masks, True, keys=(key,))
        assert list(one) == [key] and torch.equal(one[key], full[key])


@pytest.mark.parametrize("magnitude", [1 << DEPTH, (1 << DEPTH) + 7])
def test_predicate_masks_refuse_out_of_depth(magnitude):
    for mod in (jbsi, tbsi):
        with pytest.raises(ValueError):
            mod.predicate_masks(magnitude, DEPTH)
    assert np.array_equal(tbsi.predicate_masks(300, DEPTH),
                          jbsi.predicate_masks(300, DEPTH))


@pytest.mark.parametrize("op_key,value,verdict", [
    ("lt", 600, True), ("le", 600, True), ("ne", 600, True),
    ("gt", 600, False), ("ge", 600, False), ("eq", 600, False),
    ("gt", -600, True), ("ge", -600, True), ("ne", -600, True),
    ("lt", -600, False), ("le", -600, False), ("eq", -600, False),
    ("lt", 511, None), ("gt", -511, None)])
def test_saturation_past_depth(op_key, value, verdict):
    """A predicate past +-(2^depth - 1) answers every non-null column or
    none, by the executor's rule (``executor.bsi_offset``)."""
    from pilosa_tpu_torch.exec.executor import bsi_offset
    from pilosa_tpu_torch.store.field import FieldOptions

    class F:
        options = FieldOptions(type="int", bit_depth=DEPTH)

        @staticmethod
        def to_stored(v):
            return int(v)
    offset, got = bsi_offset(F, op_key, value)
    assert offset == value and got is verdict
    if verdict is not None:
        # the oracle agrees: every stored value is within the depth
        cmp = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
               "ge": np.greater_equal, "eq": np.equal,
               "ne": np.not_equal}[op_key]
        assert cmp(VALUES[EXISTS], value).all() == verdict
        assert (~cmp(VALUES[EXISTS], value)).all() == (not verdict)


@pytest.mark.parametrize("with_filter", [False, True])
def test_bit_counts_and_sum_equal(with_filter):
    f = FILT if with_filter else None
    jp, jn, jc = jbsi.bit_counts(jnp.asarray(PLANE),
                                 None if f is None else jnp.asarray(f))
    tp, tn, tc = tbsi.bit_counts(port(PLANE),
                                 None if f is None else port(f))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert tbsi.combine_sum(tp, tn, tc) == jbsi.combine_sum(jp, jn, jc)
    ok = EXISTS if f is None else EXISTS & np.unpackbits(
        f.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    assert tbsi.combine_sum(tp, tn, tc) == (int(VALUES[ok].sum()),
                                            int(ok.sum()))


def _mixed_shards():
    """Shards that are all negative, all positive, mixed, and empty."""
    neg, _, _ = make_plane(3, 1, 11, signs="neg")
    pos, _, _ = make_plane(4, 1, 11, signs="pos")
    mixed, _, _ = make_plane(5, 1, 11)
    empty = np.zeros_like(mixed)
    one, _, _ = make_plane(6, 1, 11, fill=0.0005)   # a handful of values
    return np.concatenate([neg, pos, mixed, empty, one])


@pytest.mark.parametrize("with_filter", [False, True])
def test_min_max_equal(with_filter):
    plane = _mixed_shards()
    f = filt(7, plane.shape[0]) if with_filter else None
    want = jbsi.min_max_bits(jnp.asarray(plane),
                             None if f is None else jnp.asarray(f))
    got = tbsi.min_max_bits(port(plane), None if f is None else port(f))
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert tbsi.combine_min_max(got) == jbsi.combine_min_max(want)
    # the packed form decodes to the same tuples
    packed = tbsi.pack_min_max(got).numpy()
    assert tbsi.decode_minmax_packed(packed) == jbsi.combine_min_max(want)


@pytest.mark.parametrize("depth,shards", [(6, 3), (12, 2)])
@pytest.mark.parametrize("with_filter", [False, True])
def test_distinct_presence_equal(depth, shards, with_filter, monkeypatch):
    """Depth 6 takes the value-space path, depth 12 the column-scatter
    path (with blocks of 1 shard, so the block loop runs)."""
    plane, values, exists = make_plane(8 + depth, shards, depth, w=64)
    f = filt(9, shards, 64) if with_filter else None
    want = jbsi.distinct_presence(jnp.asarray(plane),
                                  None if f is None else jnp.asarray(f))
    monkeypatch.setattr(tbsi, "DISTINCT_BLOCK", 1)
    got = tbsi.distinct_presence(port(plane),
                                 None if f is None else port(f))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    ok = exists if f is None else exists & np.unpackbits(
        f.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    present = set(np.nonzero(got[0].numpy())[0].tolist()) | {
        -int(v) for v in np.nonzero(got[1].numpy())[0]}
    assert present == set(values[ok].tolist())


@pytest.mark.parametrize("nth", [0, 50, 99.9, 100])
@pytest.mark.parametrize("with_filter", [False, True])
def test_percentile_equal(nth, with_filter):
    import math
    f = FILT if with_filter else None
    jf = None if f is None else jnp.asarray(f)
    total = int(jbsi.percentile_total(jnp.asarray(PLANE), jf))
    target = min(total, max(1, math.ceil(nth / 100.0 * total)))
    want = np.asarray(jbsi.percentile_search(jnp.asarray(PLANE), jf,
                                             jnp.int32(target)))
    out, got_total = FusedCache.run_percentile(
        port(PLANE), None if f is None else port(f), nth)
    assert got_total == total
    assert out.tolist() == want.tolist()
    ok = EXISTS if f is None else EXISTS & np.unpackbits(
        f.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    s = np.sort(VALUES[ok])
    assert out.tolist() == [int(s[target - 1]),
                            int((s == s[target - 1]).sum())]


def test_percentile_empty():
    out, total = FusedCache.run_percentile(
        port(np.zeros((2, DEPTH + 2, W), np.uint32)), None, 50)
    assert out is None and total == 0


def test_decode_sum_packed_equal():
    fused = FusedCache()
    out = fused.run_sum_plane_batch(port(PLANE), (False, True),
                                    (port(FILT),))
    jp, jn, jc = jbsi.bit_counts(jnp.asarray(PLANE), jnp.asarray(FILT))
    row = np.concatenate([np.asarray(jp), np.asarray(jn),
                          np.asarray(jc)[:, None]], axis=-1)
    assert np.array_equal(out.numpy()[1], row)
    assert tbsi.decode_sum_packed(out.numpy()[1]) == \
        jbsi.decode_sum_packed(row)
