"""One run of one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Earlier lines of standard output give the device, its power limit, the
configuration's cuts, the set-up's stages and the bytes the process
wrote; the last line is the result as one JSON object.  The numbers
compared for ``correct`` are the last lines of standard error and the
result's last key.  Without the cards the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result
and exits with another code than 0."""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import harness, roofline, trace, traffic  # noqa: E402


def bytes_written() -> int:
    """This process's bytes passed to write calls (``wchar``)."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    return -1


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().replace("\n", "; ") or "unknown"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
        device=None, t_proc0: float = T_PROC0, log=print,
        cfg=None, wrap=None):
    """Set up, measure, check.  Returns (result dict without ``device``,
    the counts compared, the device's peak bytes).  ``cfg`` overrides the
    configuration file (the tests' small sizes); ``wrap(program)`` may
    replace the program's query path (the tests' planted faults)."""
    cfg = cfg or harness.load_config(cell["config"])
    mix = traffic.load(cell["traffic"])
    t = time.perf_counter()
    columns = harness.generate(cfg, seed)
    t_gen = time.perf_counter() - t
    program = harness.Program(cfg, device=device)
    t = time.perf_counter()
    program.load(cfg, columns)
    t_load = time.perf_counter() - t
    t = time.perf_counter()
    n_warm = harness.warm(program, mix, seed)
    t_warm = time.perf_counter() - t
    log(f"setup: {len(columns[next(iter(columns))])} columns; generate "
        f"{t_gen:.3f} s, import {t_load:.3f} s, "
        f"warm-up {t_warm:.3f} s ({n_warm} requests)")
    if wrap is not None:
        wrap(program)
    before = harness.hist_totals(program.stats)
    prof = None

    def on_start():
        nonlocal prof
        if traced:
            prof = trace.start()

    win = harness.window(program, mix, seed, seconds, on_start=on_start)
    events = trace.stop(prof) if prof is not None else None
    hist = harness.hist_delta(before, harness.hist_totals(program.stats))
    peak = 0
    if device != "cpu":
        import torch
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))
    program.close()
    del program
    setup_s = win["start"] - t_proc0
    recs = win["records"]
    log(f"window: {len(recs)} requests sent in {seconds} s, "
        f"{sum('t_done' in r for r in recs)} returned, last at "
        f"{win['last'] - win['start']:.3f} s")
    errs = sorted({r["error"] for r in recs if "error" in r})
    for e in errs[:3]:
        log(f"error: {e[:500]}")
    t = time.perf_counter()
    counts = harness.check(win, columns, cfg)
    log(f"reference: {time.perf_counter() - t:.3f} s")
    name = cell["name"]
    result = {"correct": harness.is_correct(counts),
              "attempted": len(recs),
              "failed": counts["wrong"] + counts["errors"]
              + counts["unanswered"]}
    if not traced:
        e2e = harness.end_to_end(win, setup_s)
        result["metrics"] = {m["name"]: e2e[m["name"]]
                             for m in bench["end_to_end"]
                             if applies(m, name) and m["name"] in e2e}
        return result, counts, peak, None
    bsi = harness.bsi_shapes(cfg, columns)
    done = [r for r in recs if "result" in r]
    summary = trace.reduce(events) if events is not None else None
    if summary is not None:
        summary["window_s"] = win["last"] - win["start"]
    ctx = {"records": recs, "completed": len(done), "hist": hist,
           "trace": summary,
           "request_bytes": [roofline.request_bytes(
               r["calls"], cfg["fields"], bsi, cfg["shards"]) for r in done]}
    names = [m["name"] for m in bench["per_layer"] if applies(m, name)]
    result["metrics"] = harness.per_layer(names, ctx)
    return result, counts, peak, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"no result: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = harness.load_config(cell["config"])
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{cell['chips']} of {torch.cuda.device_count()}; "
          f"nvidia-smi name, power.limit: {power_limit()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"cuts: {cfg['name']} {cfg['shards']} shards of the published "
          f"{json.dumps(cfg['published'])}; reduced {cfg['reduced']}")
    sys.stdout.flush()
    result, counts, peak, summary = run(
        bench, cell, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": kind,
                        "count": cell["chips"], "memory_peak_bytes": peak}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = harness.compared(counts)
    print(f"bytes written: {bytes_written()} (wchar of this process)")
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the program's worker threads need no join: the holder is deleted
    os._exit(code)
