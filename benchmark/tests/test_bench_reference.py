"""The data-cube reference against a plain mask evaluation, and against
the port at one shard on the CPU, for every template of every mix."""

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.reference import cube

MIXES = {"taxi.dash-c32": "nyc-taxi", "ssb.flights-c1": "ssb-sf10"}


def plain(columns, fields, call):
    """One call by boolean masks over every row: the loop version."""
    n = len(next(iter(columns.values())))
    m = np.ones(n, bool)
    for t in call["filter"]:
        v = columns[t["field"]]
        if "eq" in t:
            m &= v == t["eq"]
        elif "in" in t:
            m &= np.isin(v, t["in"])
        elif "ge" in t:
            m &= v >= t["ge"]
        elif "lt" in t:
            m &= v < t["lt"]
        else:
            m &= (v >= t["between"][0]) & (v <= t["between"][1])
    kind = call["call"]
    if kind == "sum":
        return {"value": int(columns[call["field"]][m].sum()),
                "count": int(m.sum())}
    if kind == "topn":
        c = np.bincount(columns[call["field"]][m],
                        minlength=fields[call["field"]]["rows"])
        return [{"id": int(r), "count": int(c[r])}
                for r in sorted(np.flatnonzero(c), key=lambda r: (-c[r], r))]
    groups = {}
    agg = call.get("sum")
    for i in np.flatnonzero(m):
        key = tuple(int(columns[f][i]) for f in call["rows"])
        g = groups.setdefault(key, [0, 0])
        g[0] += 1
        if agg:
            g[1] += int(columns[agg][i])
    out = []
    for key in sorted(groups):
        g = {"group": [{"field": f, "rowID": r}
                       for f, r in zip(call["rows"], key)],
             "count": groups[key][0]}
        if agg:
            g["agg"] = groups[key][1]
        out.append(g)
    return out


def tiny_columns(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f, spec in cfg["fields"].items():
        if spec["type"] == "set":
            out[f] = rng.integers(0, spec["rows"], n).astype(np.uint8)
        else:
            hi = min(spec["max"], 6000)
            out[f] = rng.integers(spec["min"], hi + 1, n).astype(np.int64)
    return out


@pytest.mark.parametrize("mix_name", sorted(MIXES))
def test_cube_equals_plain_evaluation(mix_name):
    cfg = harness.load_config(MIXES[mix_name])
    mix = traffic.load(mix_name)
    columns = tiny_columns(cfg, 4000, 3)
    reqs = [r for c in range(3) for r, _ in
            zip(traffic.deck(mix, 9, c), range(2 * len(mix["templates"])))]
    got = cube.answer(columns, cfg["fields"], reqs)
    for r, answers in zip(reqs, got):
        assert answers == [plain(columns, cfg["fields"], c)
                           for c in r["calls"]], r["pql"][:200]


def test_cube_sum_and_count_of_an_empty_filter():
    fields = {"f": {"type": "set", "rows": 3},
              "v": {"type": "int", "min": 0, "max": 100}}
    columns = {"f": np.array([0, 1, 1], np.uint8),
               "v": np.array([5, 7, 9], np.int64)}
    call = {"call": "sum", "field": "v",
            "filter": [{"field": "f", "eq": 2}, {"field": "v", "ge": 6}]}
    grp = {"call": "groupby", "rows": ["f"], "sum": "v",
           "filter": [{"field": "v", "between": [6, 9]}]}
    assert cube.answer(columns, fields, [{"calls": [call, grp]}]) == [[
        {"value": 0, "count": 0},
        [{"group": [{"field": "f", "rowID": 1}], "count": 2, "agg": 16}]]]


@pytest.mark.parametrize("mix_name", sorted(MIXES))
def test_reference_equals_the_port_on_the_cpu(small, mix_name):
    cfg = small(MIXES[mix_name])
    mix = traffic.load(mix_name)
    columns = harness.generate(cfg, 2**31 + 3)
    program = harness.Program(cfg, device="cpu")
    try:
        program.load(cfg, columns, 2)
        d = traffic.deck(mix, 2**31 + 3, 0)
        reqs = [next(d) for _ in mix["templates"]]
        records = [dict(r, result=program.query(r["pql"]), t_send=0.0,
                        t_done=0.0) for r in reqs]
    finally:
        program.close()
    counts = harness.check({"records": records}, columns, cfg)
    assert counts == {"wrong": 0, "errors": 0, "unanswered": 0}
    # not a comparison of empty answers: every request found rows
    answers = cube.answer(columns, cfg["fields"], reqs)
    assert all(any(a not in (0, [], {"value": 0, "count": 0}) for a in req)
               for req in answers)
