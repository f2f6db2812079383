"""The generators and the harness's roaring encoder."""

import numpy as np
import pytest

from benchmark import encode, harness
from pilosa_tpu_torch.store import roaring


@pytest.mark.parametrize("name", ["nyc-taxi", "ssb-sf10"])
def test_generator_repeats_from_its_seed(small, name):
    cfg = small(name)
    a, b = harness.generate(cfg, 2**31 + 11), harness.generate(cfg, 2**31 + 11)
    c = harness.generate(cfg, 5)
    assert sorted(a) == sorted(cfg["fields"])
    for f, spec in cfg["fields"].items():
        assert len(a[f]) == cfg["shards"] * harness.SHARD_WIDTH
        np.testing.assert_array_equal(a[f], b[f])
        if spec["type"] == "set":
            assert a[f].min() >= 0 and a[f].max() < spec["rows"]
        else:
            assert a[f].min() >= spec["min"] and a[f].max() <= spec["max"]
    assert any(not np.array_equal(a[f], c[f]) for f in a)


def test_taxi_columns_arrive_in_runs(small):
    cols = harness.generate(small("nyc-taxi"), 3)
    assert (np.diff(cols["pickup_year"].astype(int)) >= 0).all()
    # one yellow block and one green block per month at most
    assert np.count_nonzero(np.diff(cols["cab_type"].astype(int))) <= 2 * 84


@pytest.mark.parametrize("kind", ["random", "runs", "sparse", "one_row",
                                  "mixed"])
def test_encoder_round_trips(kind):
    rng = np.random.default_rng(7)
    n = harness.SHARD_WIDTH
    rows = {"random": rng.integers(0, 10, n),
            "runs": np.sort(rng.integers(0, 7, n)),
            "sparse": np.minimum(rng.geometric(0.2, n), 63),
            "one_row": np.zeros(n, np.int64),
            "mixed": np.where(np.arange(n) < n // 2, 3,
                              rng.integers(0, 64, n))}[kind]
    pos = encode.positions(rows)
    assert (np.diff(pos.astype(np.int64)) > 0).all()
    blob = encode.encode_positions(pos)
    np.testing.assert_array_equal(encode.decode(blob), pos)
    np.testing.assert_array_equal(roaring.deserialize(blob), pos)
    # the smallest container of each kind: the port's own writer agrees
    assert blob == roaring.serialize(pos)


def test_encoder_empty_and_single():
    assert encode.decode(encode.encode_positions(np.zeros(0, np.uint64))).size == 0
    one = np.array([5 << 20 | 77], np.uint64)
    np.testing.assert_array_equal(roaring.deserialize(
        encode.encode_positions(one)), one)


def test_columns_do_not_depend_on_the_thread_count(small):
    cfg = small("nyc-taxi")
    cfg["shards"] = 2
    a = harness.generate(cfg, 2**33 + 1, threads=1)
    b = harness.generate(cfg, 2**33 + 1, threads=4)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])


def test_ssb_last_shard_holds_the_rest_of_the_lines(small):
    cfg = small("ssb-sf10")
    cfg["shards"] = 2
    cfg["generator_params"]["scale_factor"] = 0.3
    cols = harness.generate(cfg, 17)
    n = len(cols["lo_year"])
    assert harness.SHARD_WIDTH < n < 2 * harness.SHARD_WIDTH
    assert cols["lo_quantity"].min() >= 1 and cols["lo_quantity"].max() <= 50
    assert cols["lo_year"].max() <= 6 and cols["lo_discount"].max() <= 10
    np.testing.assert_array_equal(
        cols["lo_revenue"],
        cols["lo_extendedprice"] * (100 - cols["lo_discount"]) // 100)
    cfg["shards"] = 3  # more shards than the lines fill
    with pytest.raises(ValueError):
        harness.generate(cfg, 17)


@pytest.mark.parametrize("kind", ["fare", "sparse_high_bits", "signed",
                                  "partial_shard", "constant"])
def test_bsi_encoder_round_trips(kind):
    rng = np.random.default_rng(11)
    n = harness.SHARD_WIDTH
    values, base, depth = {
        "fare": (rng.integers(0, 1 << 17, n), 0, 17),
        "sparse_high_bits": (np.minimum(rng.lognormal(7.3, 0.7, n),
                                        131071).astype(np.int64), 0, 17),
        "signed": (rng.integers(-500, 500, n), 0, 9),
        "partial_shard": (rng.integers(100, 164, 300_000), 100, 6),
        "constant": (np.full(n, 5), 0, 3),
    }[kind]
    bits = encode.bsi_rows(values, base, depth)
    r, c = np.nonzero(bits)
    pos = (r.astype(np.uint64) << np.uint64(20)) | c.astype(np.uint64)
    pos.sort()
    blob = encode.encode_rows(bits)
    np.testing.assert_array_equal(encode.decode(blob), pos)
    np.testing.assert_array_equal(roaring.deserialize(blob), pos)
    assert blob == roaring.serialize(pos)
    # the values come back from the planes
    mag = sum(bits[2 + b].astype(np.int64) << b for b in range(depth))
    np.testing.assert_array_equal(np.where(bits[1], -mag, mag) + base,
                                  values)


def test_every_seed_sends_the_same_templates_in_turn():
    from benchmark import traffic
    mix = traffic.load("taxi.dash-c32")
    names = [t["name"] for t in mix["templates"]]
    for c in range(mix["clients"]):
        a = [r for r, _ in zip(traffic.deck(mix, 1, c), range(12))]
        b = [r for r, _ in zip(traffic.deck(mix, 2**40 + 3, c), range(12))]
        assert [r["template"] for r in a] == [r["template"] for r in b] == \
            [names[(c + k) % len(names)] for k in range(12)]
        assert [r["pql"] for r in a] != [r["pql"] for r in b]
