"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, CUDA activity only (CUPTI's kernel, copy and set
records with device timestamps), reduced to what the per-layer readers
and the ``breakdown`` need.  A window of GroupBy Sums holds millions of
records of a few dozen kernel names, so each name is shortened once."""

from __future__ import annotations

import functools
import re

COPY_PREFIXES = ("Memcpy", "Memset")


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    return prof


def stop(prof) -> list:
    """Close the profiler; the device records as ``(start_ns, end_ns,
    name)``, sorted by start."""
    import torch
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        s = int(e.start_ns())
        out.append((s, s + int(e.duration_ns()), e.name()))
    out.sort()
    return out


@functools.lru_cache(maxsize=None)
def short(name: str) -> str:
    """A kernel's name without namespaces' decorations, template
    arguments and argument list, at most 80 characters; a generic torch
    kernel keeps the operation it was instantiated for in brackets."""
    tag = next((m.group(0) for m in (
        re.search(p, name) for p in (r"\w+_kernel_cuda", r"\w+_functor",
                                     r"\w+Functor")) if m), None)
    name = name.replace("(anonymous namespace)::", "")
    name = name.replace("<unnamed>::", "")
    while True:
        new = re.sub(r"<[^<>]*>", "", name)
        if new == name:
            break
        name = new
    name = re.sub(r"\(.*$", "", name)
    name = re.sub(r"^void ", "", name).strip() or "?"
    if tag and tag not in name:
        name += f"[{tag}]"
    return name[:80]


def reduce(events: list, top: int = 10) -> dict:
    """Busy seconds (the union of the records' intervals), the kernels
    counted, the ``top`` device operations by time and the ``top`` longest
    gaps between busy stretches, each named by the operations on either
    side of it."""
    busy = 0
    gaps = []
    cur_s = cur_e = None
    cur_name = None
    by_name: dict = {}
    kernels = 0
    for s, e, name in events:
        n = short(name)
        by_name[n] = by_name.get(n, 0) + (e - s)
        if not name.startswith(COPY_PREFIXES):
            kernels += 1
        if cur_e is None:
            cur_s, cur_e, cur_name = s, e, n
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, f"after {cur_name}, before {n}"))
            cur_s, cur_e, cur_name = s, e, n
        elif e > cur_e:
            cur_e, cur_name = e, n
    if cur_e is not None:
        busy += cur_e - cur_s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, reverse=True)[:top]
    return {"busy_s": busy / 1e9, "kernels": kernels,
            "records": len(events),
            "device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": [[label, g / 1e9] for g, label in longest]}
