"""The control of ``correct``: the plain reference put in the program's
place at one bit less of every int field's stated depth (the lowest bit
plane dropped, ``v & ~1``), the precision step below what the
configurations state.  Its answers are judged as the program's are, by
the exact reference, and have to come out wrong.

    python3 -m benchmark.control --workload <cell> --seed <n> [--seed <n> ...]

draws, for each seed, the requests a window of the cell sends first
(``--per-client`` of each client's) over the cell's data at
its full size, and prints the counts compared.  It needs no card and
runs none of the program."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark import harness, traffic
from benchmark.reference import cube


def lower_precision(columns: dict, fields: dict) -> dict:
    out = dict(columns)
    for f, spec in fields.items():
        if spec["type"] == "int":
            out[f] = columns[f] & ~np.int64(1)
    return out


def window_requests(mix: dict, seed: int, per_client: int) -> list:
    out = []
    for c in range(mix["clients"]):
        d = traffic.deck(mix, seed, c)
        out += [next(d) for _ in range(per_client)]
    return out


def readings(cfg: dict, mix: dict, seed: int, per_client: int,
             answer=None) -> dict:
    """The counts compared when ``answer(columns, fields, requests)``
    (default: the control) answers in the program's place."""
    columns = harness.generate(cfg, seed)
    reqs = window_requests(mix, seed, per_client)
    if answer is None:
        def answer(cols, fields, rs):
            return cube.answer(lower_precision(cols, fields), fields, rs)
    got = answer(columns, cfg["fields"], reqs)
    records = [dict(r, result=g, t_send=0.0, t_done=0.0)
               for r, g in zip(reqs, got)]
    win = {"records": records}
    return harness.check(win, columns, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--per-client", type=int, default=8)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    cfg = harness.load_config(cell["config"])
    mix = traffic.load(cell["traffic"])
    for seed in args.seed:
        t = time.perf_counter()
        counts = readings(cfg, mix, seed, args.per_client)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "requests": mix["clients"] * args.per_client,
                          "compared": harness.compared(counts),
                          "correct": harness.is_correct(counts),
                          "seconds": time.perf_counter() - t}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
