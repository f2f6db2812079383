"""The Star Schema Benchmark's ``lineorder``, denormalised as the SSB
demo loads it: one column per line, in order key order, with the
customer's, supplier's and part's attributes and the order date's parts
copied onto it.

The rules are ``dbgen``'s: 1.5M orders per scale factor, 1 to 7 lines
each; an order's date uniform from 1992-01-01 to 1998-08-02 and its
customer uniform over 30,000 per scale factor; a line's part uniform over
``200,000 * floor(1 + log2 SF)`` and its supplier over 2,000 per scale
factor (200,000 * SF below SF 1); quantity uniform 1-50, discount 0-10; a part's retail price in
cents ``90000 + (key / 10) % 20001 + 100 * (key % 1000)``; extended price
``quantity * retail``, revenue ``extended * (100 - discount) / 100``,
supply cost ``6 * retail / 10``.  Customers and suppliers take a nation
uniformly, each nation in its TPC-H region; a part takes a manufacturer
1-5 and a category within it.  The configuration's shards hold every
line, the last one in part; lines past its last shard are dropped.

Orders, customers, suppliers and parts are drawn once
(:func:`prepare`), each line's own draws per shard (:func:`fill`)."""

from __future__ import annotations

import datetime as _dt
import math

import numpy as np

SHARD_WIDTH = 1 << 20
# TPC-H's nations in key order -> region (AFRICA 0, AMERICA 1, ASIA 2,
# EUROPE 3, MIDDLE EAST 4)
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0,
                          1, 2, 3, 4, 2, 3, 3, 1], np.uint8)


def prepare(cfg: dict, rng: np.random.Generator) -> dict:
    sf = cfg["generator_params"]["scale_factor"]
    shards = cfg["shards"]
    orders = int(1_500_000 * sf)
    lines = rng.integers(1, 8, orders)
    n = min(int(lines.sum()), shards * SHARD_WIDTH)
    if n <= (shards - 1) * SHARD_WIDTH:
        raise ValueError(f"scale factor {sf} holds {n} lines, too few "
                         f"for {shards} shards")
    order_of = np.repeat(np.arange(orders, dtype=np.int32), lines)[:n]
    start = _dt.date(1992, 1, 1)
    days = (_dt.date(1998, 8, 2) - start).days + 1
    date = np.datetime64(start) + rng.integers(0, days, orders).astype(
        "timedelta64[D]")
    year = date.astype("datetime64[Y]").astype(np.int64) - 22  # 1992 -> 0
    month0 = date.astype("datetime64[M]").astype(np.int64) % 12
    doy = (date - date.astype("datetime64[Y]")).astype(np.int64)
    cust_nation = rng.integers(0, 25, int(30_000 * sf))
    n_parts = int(200_000 * (math.floor(1 + math.log2(sf)) if sf >= 1
                             else sf))
    part_mfgr = rng.integers(0, 5, n_parts + 1)
    columns = {f: np.empty(n, np.int64 if spec["type"] == "int"
                           else np.uint8)
               for f, spec in cfg["fields"].items()}
    return {
        "sf": sf, "n": n, "columns": columns, "order_of": order_of,
        "o_year": year.astype(np.uint8),
        "o_yearmonth": (year * 12 + month0).astype(np.uint8),
        "o_weeknum": (doy // 7).astype(np.uint8),
        "o_c_nation": cust_nation[rng.integers(0, len(cust_nation),
                                               orders)].astype(np.uint8),
        "supp_nation": rng.integers(0, 25, int(2_000 * sf)).astype(np.uint8),
        "n_parts": n_parts, "part_mfgr": part_mfgr,
        "part_cat": part_mfgr * 5 + rng.integers(0, 5, n_parts + 1),
    }


def fill(state: dict, shard: int, rng: np.random.Generator) -> None:
    """One shard's lines: the order's date and customer, the line's own
    supplier, part, quantity and discount."""
    lo = shard * SHARD_WIDTH
    hi = min(lo + SHARD_WIDTH, state["n"])
    n = hi - lo
    col = state["columns"]
    o = state["order_of"][lo:hi]
    for f in ("year", "yearmonth", "weeknum"):
        col["lo_" + f][lo:hi] = state["o_" + f][o]
    c_nation = state["o_c_nation"][o]
    col["c_nation"][lo:hi] = c_nation
    col["c_region"][lo:hi] = NATION_REGION[c_nation]
    supp = state["supp_nation"]
    s_nation = supp[rng.integers(0, len(supp), n)]
    col["s_nation"][lo:hi] = s_nation
    col["s_region"][lo:hi] = NATION_REGION[s_nation]
    part = rng.integers(1, state["n_parts"] + 1, n)
    col["p_mfgr"][lo:hi] = state["part_mfgr"][part]
    col["p_category"][lo:hi] = state["part_cat"][part]
    retail = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
    quantity = rng.integers(1, 51, n)
    discount = rng.integers(0, 11, n)
    extended = quantity * retail
    col["lo_quantity"][lo:hi] = quantity
    col["lo_discount"][lo:hi] = discount
    col["lo_extendedprice"][lo:hi] = extended
    col["lo_revenue"][lo:hi] = extended * (100 - discount) // 100
    col["lo_supplycost"][lo:hi] = 6 * retail // 10
