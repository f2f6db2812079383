"""The one traffic generator: reads a mix (``traffic/<name>.json``) and
gives each client an endless deck of requests drawn from the seed.

A mix holds ``clients`` and ``templates``.  A template has ``params``,
each a closed integer range ``[lo, hi]`` drawn uniformly per request,
and ``calls``, each one PQL call of a request:

- ``{"call": "topn", "field": f, "filter": [...]}`` -> ``TopN(f, <filter>)``
- ``{"call": "sum", "field": f, "filter": [...]}`` -> ``Sum(<filter>, field=f)``
- ``{"call": "groupby", "rows": [f, ...], "filter": [...], "sum": g}`` ->
  ``GroupBy(Rows(f), ..., filter=<filter>, aggregate=Sum(field=g))``

A filter is a list of terms, all of which hold: ``{"field": f, "eq": v}``,
``"in": [v, ...]`` (any of them), ``"ge": v``, ``"lt": v`` or
``"between": [lo, hi]`` (inclusive).  A value is an integer or a string
of ``+``-joined terms, each an integer or ``$param``.  A call with
``"each": {"k": [lo, hi], ...}`` stands for one call per point of the
product of those ranges, ``$k`` bound in each.

Each client sends every template in turn, starting at the template of
its own number, so the clients spread over the templates alike and every
seed sends the same sequence of templates; the seed draws each request's
constants.  The work of a window then moves with the program, not with
the seed's order of cheap and dear requests."""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RANGE_OPS = ("ge", "lt", "between")


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def seed_sequence(seed: int, *stream: int) -> np.random.SeedSequence:
    """Entropy for one stream of a run: any whole ``seed`` (negative ones
    apart from positive ones)."""
    return np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream])


def value(v, env: dict) -> int:
    if isinstance(v, int):
        return v
    total = 0
    for term in str(v).split("+"):
        term = term.strip()
        total += env[term[1:]] if term.startswith("$") else int(term)
    return total


def resolve_term(term: dict, env: dict) -> dict:
    out = {"field": term["field"]}
    for op in ("eq", "ge", "lt"):
        if op in term:
            out[op] = value(term[op], env)
    if "in" in term:
        out["in"] = [value(v, env) for v in term["in"]]
    if "between" in term:
        out["between"] = [value(v, env) for v in term["between"]]
    return out


def resolve_calls(calls: list, env: dict) -> list:
    """A template's calls with ``env``'s values bound, ``each`` expanded."""
    out = []
    for call in calls:
        each = call.get("each", {})
        names = sorted(each)
        for point in itertools.product(*(range(each[k][0], each[k][1] + 1)
                                          for k in names)):
            e = dict(env, **dict(zip(names, point)))
            c = {k: v for k, v in call.items() if k not in ("each", "filter")}
            c["filter"] = [resolve_term(t, e) for t in call.get("filter", [])]
            out.append(c)
    return out


def term_pql(t: dict) -> str:
    f = t["field"]
    if "eq" in t:
        return f"Row({f}={t['eq']})"
    if "in" in t:
        return "Union(" + ", ".join(f"Row({f}={v})" for v in t["in"]) + ")"
    if "ge" in t:
        return f"Row({f} >= {t['ge']})"
    if "lt" in t:
        return f"Row({f} < {t['lt']})"
    lo, hi = t["between"]
    return f"Row({lo} <= {f} <= {hi})"


def filter_pql(terms: list) -> str | None:
    if not terms:
        return None
    parts = [term_pql(t) for t in terms]
    return parts[0] if len(parts) == 1 else "Intersect(" + ", ".join(parts) + ")"


def call_pql(c: dict) -> str:
    flt = filter_pql(c["filter"])
    kind = c["call"]
    if kind == "topn":
        return f"TopN({c['field']}" + (f", {flt})" if flt else ")")
    if kind == "sum":
        return f"Sum({flt}, field={c['field']})"
    if kind == "groupby":
        args = [f"Rows({r})" for r in c["rows"]]
        if flt:
            args.append(f"filter={flt}")
        if c.get("sum"):
            args.append(f"aggregate=Sum(field={c['sum']})")
        return "GroupBy(" + ", ".join(args) + ")"
    raise ValueError(f"unknown call {kind!r}")


def request(template: dict, rng: np.random.Generator) -> dict:
    env = {k: int(rng.integers(lo, hi + 1))
           for k, (lo, hi) in sorted(template.get("params", {}).items())}
    calls = resolve_calls(template["calls"], env)
    return {"template": template["name"], "calls": calls,
            "pql": " ".join(call_pql(c) for c in calls)}


def deck(mix: dict, seed: int, client: int, stream: int = 1):
    """Client ``client``'s endless requests: every template in turn from
    template ``client`` on.  ``stream`` 1 is the measured window's; set-up
    draws its warm-up from others."""
    rng = np.random.default_rng(seed_sequence(seed, stream, client))
    templates = mix["templates"]
    for k in itertools.count(client):
        yield request(templates[k % len(templates)], rng)
