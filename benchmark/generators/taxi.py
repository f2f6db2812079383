"""NYC TLC trips in import order, as the taxi demo loads them.

Columns are rides in chronological order: the seven years in turn, each
split by the year's trip volume, each month a block of yellow rides and
then a block of green ones (the TLC publishes one file per month and
cab type), so ``pickup_year`` and ``cab_type`` hold long runs.  Trip
distance is log-normal, ``dist_miles`` its rounded value capped at the
top row; ``total_amount`` in cents is a metered fare on that distance
plus a log-normal tip and surcharge, so the fare filter correlates with
the distance groups as it does in the TLC data.  Every share is in the
configuration's ``generator_params``."""

from __future__ import annotations

import numpy as np

SHARD_WIDTH = 1 << 20


def prepare(cfg: dict, rng: np.random.Generator) -> dict:
    """The columns of every ride, the year and cab blocks laid out; the
    per-ride draws are left to :func:`fill`."""
    p = cfg["generator_params"]
    n = cfg["shards"] * SHARD_WIDTH
    years = np.asarray(p["year_trips_millions"], np.float64)
    green = np.asarray(p["green_share_by_year"], np.float64)
    # column boundaries of every (year, month, cab type) block
    bounds = np.concatenate(([0.0], np.cumsum(years) / years.sum()))
    year = np.zeros(n, np.uint8)
    cab = np.zeros(n, np.uint8)
    for y in range(len(years)):
        lo, hi = int(bounds[y] * n), int(bounds[y + 1] * n)
        year[lo:hi] = y
        months = np.linspace(lo, hi, 13).astype(np.int64)
        for m in range(12):
            a, b = months[m], months[m + 1]
            g = int(round((b - a) * green[y]))
            cab[b - g:b] = 1
    columns = {"cab_type": cab, "passenger_count": np.empty(n, np.uint8),
               "pickup_year": year, "dist_miles": np.empty(n, np.uint8),
               "total_amount": np.empty(n, np.int64)}
    return {"cfg": cfg, "n": n, "columns": columns}


def fill(state: dict, shard: int, rng: np.random.Generator) -> None:
    """Draw one shard's passengers, distances and fares."""
    cfg = state["cfg"]
    p = cfg["generator_params"]
    lo = shard * SHARD_WIDTH
    hi = min(lo + SHARD_WIDTH, state["n"])
    n = hi - lo
    col = state["columns"]
    share = np.asarray(p["passenger_share"], np.float64)
    col["passenger_count"][lo:hi] = rng.choice(len(share), size=n,
                                               p=share / share.sum())
    miles = rng.lognormal(np.log(p["miles_median"]), p["miles_sigma"], n)
    rows = cfg["fields"]["dist_miles"]["rows"]
    col["dist_miles"][lo:hi] = np.minimum(np.rint(miles), rows - 1)
    extra = rng.lognormal(np.log(p["extra_cents_median"]),
                          p["extra_cents_sigma"], n)
    fare = p["flag_cents"] + p["cents_per_mile"] * miles + extra
    top = cfg["fields"]["total_amount"]["max"]
    col["total_amount"][lo:hi] = np.minimum(np.rint(fare), top)
