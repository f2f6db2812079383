"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the numbers of the result line.

The program under test is ``pilosa_tpu_torch``: a holder, an executor at
the server's serving defaults (with the configuration's ``executor``
settings) and an ``API`` over them, in this process.  The window's
clients call ``API.query`` from their own threads."""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import encode, roofline, traffic
from benchmark.reference import cube

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SHARD_WIDTH = 1 << 20
FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")
# past the close, how long a request still in flight is waited for
LATE_S = 60.0
# shards imported at once: one per core of an 8-core H100 host
IMPORT_THREADS = 8


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def generate(cfg: dict, seed: int, threads: int = IMPORT_THREADS) -> dict:
    """The configuration's columns from the seed: what is shared drawn
    once, then each shard's own draws from a stream of its own, the
    shards on ``threads`` threads (the same columns for any count)."""
    gen = importlib.import_module(f"benchmark.generators.{cfg['generator']}")
    state = gen.prepare(cfg, np.random.default_rng(
        traffic.seed_sequence(seed, 0, 0)))

    def one(s: int) -> None:
        gen.fill(state, s, np.random.default_rng(
            traffic.seed_sequence(seed, 0, 1, s)))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(n_shards(state["n"]))))
    return state["columns"]


def n_shards(n: int) -> int:
    return -(-n // SHARD_WIDTH)


def bsi_shapes(cfg: dict, columns: dict) -> dict:
    """Each int field's (bit depth, signed): the depth its ``min`` and
    ``max`` give (pilosa's rule: values stored as offsets from ``min``
    where that is above 0), signed where a value is negative."""
    out = {}
    for f, spec in cfg["fields"].items():
        if spec["type"] == "int":
            base = spec["min"] if spec["min"] > 0 else 0
            span = max(abs(spec["min"] - base), abs(spec["max"] - base))
            out[f] = (max(1, span.bit_length()),
                      bool((columns[f] < 0).any()))
    return out


# -- the program ------------------------------------------------------------

class Program:
    """The system under test over a fresh holder under ``TMPDIR``."""

    def __init__(self, cfg: dict, device=None):
        from pilosa_tpu_torch.api import API
        from pilosa_tpu_torch.cli.config import Config
        from pilosa_tpu_torch.exec import Executor
        from pilosa_tpu_torch.obs.metrics import Stats
        from pilosa_tpu_torch.store import Holder
        dflt = Config()
        self.dir = tempfile.mkdtemp(prefix="bench-holder-")
        self.holder = Holder(self.dir, fsync=dflt.fsync).open()
        self.stats = Stats()
        opts = dict(count_batch_window=dflt.count_batch_window,
                    max_concurrent=dflt.max_concurrent_queries,
                    tree_fusion=dflt.tree_fusion,
                    plane_paging=dflt.plane_paging,
                    plane_budget=dflt.plane_budget_bytes,
                    plane_sidecars=dflt.plane_sidecars)
        opts.update(cfg.get("executor", {}))
        self.executor = Executor(self.holder, device=device,
                                 stats=self.stats, **opts)
        self.api = API(self.holder, self.executor,
                       query_timeout=dflt.query_timeout,
                       trace_sample_rate=dflt.trace_sample_rate,
                       slow_query_threshold=dflt.slow_query_threshold)
        self.index = cfg["index"]

    def load(self, cfg: dict, columns: dict,
             threads: int = IMPORT_THREADS) -> None:
        """Create the schema and load every shard: each set field as one
        roaring blob per shard through the bulk import, each int field's
        bit planes as one blob per shard as a restore pushes them (the
        merge into the field's BSI view that the port's
        ``/internal/fragment/merge`` makes)."""
        api = self.api
        api.create_index(self.index)
        for f, spec in cfg["fields"].items():
            opts = {"type": spec["type"]}
            if spec["type"] == "int":
                opts.update(min=spec["min"], max=spec["max"])
            api.create_field(self.index, f, opts)
        idx = self.holder.index(self.index)
        n = len(next(iter(columns.values())))

        def shard(s: int) -> None:
            lo, hi = s * SHARD_WIDTH, min((s + 1) * SHARD_WIDTH, n)
            for f, spec in cfg["fields"].items():
                v = columns[f][lo:hi]
                if spec["type"] == "set":
                    blob = encode.encode_positions(encode.positions(v))
                    api.import_roaring(self.index, f, s, blob)
                else:
                    fld = idx.field(f)
                    blob = encode.encode_rows(encode.bsi_rows(
                        v, fld.options.base, fld.options.bit_depth))
                    fld.bsi_view(create=True).fragment(
                        s, create=True).import_roaring(blob)

        with ThreadPoolExecutor(threads) as pool:
            for fut in [pool.submit(shard, s) for s in range(n_shards(n))]:
                fut.result()

    def query(self, pql: str) -> list:
        return self.api.query(self.index, pql)["results"]

    def wait_builds(self) -> None:
        self.executor.planes.wait_builds()

    def close(self) -> None:
        """Stop the executor's threads, drop its planes and the holder's
        files (nothing is compacted: the data goes)."""
        self.executor.close()
        self.executor.planes.invalidate()
        shutil.rmtree(self.dir, ignore_errors=True)


# -- traffic ------------------------------------------------------------------

def warm(program: Program, mix: dict, seed: int) -> int:
    """Every template once alone (each builds its planes), then one
    request per client at once (the batcher's windows and the allocator
    at the window's concurrency).  Drawn from streams of the seed that
    the window does not use.  Returns the requests sent."""
    d = traffic.deck(mix, seed, 0, stream=2)
    for _ in mix["templates"]:
        program.query(next(d)["pql"])
    program.wait_builds()
    reqs = [next(traffic.deck(mix, seed, c, stream=3))
            for c in range(mix["clients"])]
    threads = [threading.Thread(target=program.query, args=(r["pql"],),
                                daemon=True) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    program.wait_builds()
    return len(mix["templates"]) + mix["clients"]


def window(program: Program, mix: dict, seed: int, seconds: float,
           on_start=None) -> dict:
    """The closed loop: each client sends its next request when the last
    one returns, until ``seconds`` have passed; requests in flight at the
    close are waited for, up to ``LATE_S`` more.  Every request sent
    inside the window is recorded: template, calls, send and return
    times, answer or error."""
    n = mix["clients"]
    records: list = [[] for _ in range(n)]
    decks = [traffic.deck(mix, seed, c) for c in range(n)]
    ready = threading.Barrier(n + 1)
    bounds = {}

    def client(c: int) -> None:
        rec = records[c]
        ready.wait()
        t_end = bounds["end"]
        while True:
            req = next(decks[c])
            t_s = time.perf_counter()
            if t_s >= t_end:
                return
            entry = {"template": req["template"], "calls": req["calls"],
                     "t_send": t_s}
            rec.append(entry)
            try:
                entry["result"] = program.query(req["pql"])
            except Exception as e:  # the run's boundary: every error counts
                entry["error"] = f"{type(e).__name__}: {e}"
            entry["t_done"] = time.perf_counter()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    bounds["start"], bounds["end"] = t0, t0 + seconds
    ready.wait()
    deadline = bounds["end"] + LATE_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    t_last = time.perf_counter()
    return {"start": t0, "end": bounds["end"], "last": t_last,
            "records": [r for rs in records for r in rs],
            "stuck": sum(t.is_alive() for t in threads)}


# -- the end-to-end numbers ---------------------------------------------------

def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, by linear interpolation
    between the two nearest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(win: dict, setup_s: float) -> dict:
    """Rate over the whole window; latencies of every request sent in
    it, those that returned after the close included."""
    recs = win["records"]
    span = win["end"] - win["start"]
    in_window = sum(1 for r in recs if "t_done" in r and "error" not in r
                    and r["t_done"] <= win["end"])
    lat = [1000.0 * (r["t_done"] - r["t_send"]) for r in recs
           if "t_done" in r]
    out = {"requests_per_s": {"value": in_window / span,
                              "unit": "requests/s"},
           "setup_s": {"value": setup_s, "unit": "s"}}
    if lat:
        out["latency_p50_ms"] = {"value": percentile(lat, 50), "unit": "ms"}
        out["latency_p95_ms"] = {"value": percentile(lat, 95), "unit": "ms"}
    return out


# -- correctness --------------------------------------------------------------

def normalize(call: dict, got):
    """The port's answer in the reference's shapes: TopN pairs ordered by
    count, then id (the order of equal counts is not part of the answer)."""
    if call["call"] == "topn":
        return sorted(got, key=lambda p: (-p["count"], p["id"]))
    return got


def check(win: dict, columns: dict, cfg: dict) -> dict:
    """Compare every answer of the window with the reference.  Returns
    the counts compared: ``wrong`` (an answer that differs), ``errors``
    (a request that raised), ``unanswered`` (never returned)."""
    recs = [r for r in win["records"] if "result" in r]
    answers = cube.answer(columns, cfg["fields"], recs)
    wrong = 0
    for r, ref in zip(recs, answers):
        got = [normalize(c, g) for c, g in zip(r["calls"], r["result"])]
        if len(got) != len(ref) or any(g != a for g, a in zip(got, ref)):
            wrong += 1
    errors = sum(1 for r in win["records"] if "error" in r)
    unanswered = sum(1 for r in win["records"] if "t_done" not in r)
    return {"wrong": wrong, "errors": errors,
            "unanswered": unanswered}


LIMITS = {"wrong": 0, "errors": 0, "unanswered": 0}


def compared(counts: dict) -> dict:
    return {k: {"value": counts[k], "limit": LIMITS[k]} for k in LIMITS}


def is_correct(counts: dict) -> bool:
    return all(counts[k] <= LIMITS[k] for k in LIMITS)


# -- per-layer ----------------------------------------------------------------

def hist_totals(stats) -> dict:
    """Each histogram family's observation count and sum, all series."""
    out = {}
    for name, fam in stats.full_snapshot()["histograms"].items():
        out[name] = (sum(s["count"] for s in fam["series"]),
                     sum(s["sum"] for s in fam["series"]))
    return out


def hist_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, (n, s) in after.items():
        n0, s0 = before.get(name, (0, 0.0))
        out[name] = {"count": n - n0, "sum": s - s0}
    return out


def per_layer(names: list, ctx: dict) -> dict:
    """Each named metric's reader (``metrics/<name>.py``): a value, or
    None when it found nothing to read (then the metric is left out)."""
    out = {}
    for name in names:
        mod = importlib.import_module(f"benchmark.metrics.{name}")
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out
