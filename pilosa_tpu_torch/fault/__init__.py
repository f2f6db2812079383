"""Deterministic fault injection: named failpoints at the executor's and
the batcher's seams (``pilosa_tpu.fault``, the registry and the ``exec.*``
sites).

A site consults the registry through a zero-cost guard::

    if fault.ACTIVE:
        fault.fire("exec.dispatch_hang", kind=kind)

so an unarmed site costs one module-attribute load.  Triggers are
deterministic: the Nth hit of a site, or a seeded probability per hit,
optionally limited to ``times`` fires and to hits whose context matches.

Sites of this package:

- ``exec.execute``: a query after admission (``index=``);
- ``exec.oom``: each attempt of the executor's device-OOM recovery
  (``attempt=`` 1, 2, 3: a failpoint without ``match`` fires on the
  first attempt, as in the reference);
- ``exec.dispatch_hang`` / ``exec.dispatch_error``: a window group's
  launch (``kind=``);
- ``exec.readback_hang``: a window's readback;
- ``client.send``: an HTTP client request before it leaves
  (``peer=``, ``method=``, ``path=``);
- ``client.recv``: the same request after it was sent;
- ``sys.write`` / ``sys.fsync``: every durable write and fsync
  (:func:`~pilosa_tpu_torch.store.syswrap.checked_write`,
  ``checked_fsync``; ``path=``), and ``sys.mmap``: a snapshot map's
  registration;
- ``oplog.append`` and ``hints.append``: one op-log or hint-log record
  (``torn_write`` is relative to that record);
- ``server.response``: a REST request before its handler runs
  (``method=``, ``path=``);
- ``dist.fanout``: one remote leg of a cluster read (``peer=``,
  ``index=``), and ``cluster.broadcast``: one cluster message
  (``peer=``, ``path=``).

Actions: ``error`` raises :class:`FaultError` (typed by an ``errno``
arg), ``delay`` sleeps ``args.seconds``, ``oom`` raises
``torch.OutOfMemoryError`` (the type the executor's recovery classifies).
The site-interpreted ones get the spec from :func:`fire`: ``partition``
(at ``client.send``: the peer is unreachable), ``drop`` (at
``client.recv``: the response is lost; at ``cluster.broadcast``: the
message is not sent), ``torn_write`` (only ``args.offset`` bytes of the
record persist, then :func:`torn_write` raises) and ``drop_response``
(at ``server.response``: the handler runs, its answer is never sent).

Every trigger counts in :func:`triggered_total` and, once the server wired
its registry (:func:`set_stats`), on ``fault_triggered_total{site,action}``
of ``/metrics``.  A live node arms and clears failpoints through
``GET/POST /internal/fault`` and ``POST /internal/fault/clear``.
"""

from __future__ import annotations

import json
import random
import threading
import time

__all__ = ["ACTIVE", "FaultError", "set_fault", "clear", "list_faults",
           "fire", "torn_write", "configure", "set_stats", "triggered_total",
           "reset_triggered"]

ACTIONS = ("error", "delay", "oom", "torn_write", "partition",
           "drop_response", "drop")

# instrumented sites test this before calling fire()
ACTIVE = False

_lock = threading.Lock()
_registry: dict[str, list["Failpoint"]] = {}
_triggered: dict[tuple[str, str], int] = {}
_stats = None  # the metrics sink the server wires (a Stats)


class FaultError(OSError):
    """An injected fault (an OSError: at a store seam it stands in for a
    disk error).  An ``errno`` arg (``"ENOSPC"``, ``"EIO"`` or a number)
    types it for the disk governor's classification."""


def resolve_errno(value) -> int:
    """An ``errno`` fault arg as its number: an int as is, a name looked
    up in the ``errno`` module."""
    import errno as _errno_mod
    if isinstance(value, bool):
        raise ValueError(f"bad errno fault arg {value!r}")
    if isinstance(value, int):
        return value
    no = getattr(_errno_mod, str(value), None)
    if not isinstance(no, int):
        raise ValueError(
            f"unknown errno name {value!r} in fault args "
            "(use e.g. \"ENOSPC\", \"EIO\", or a number)")
    return no


class Failpoint:
    """One armed failpoint: fires on the ``nth`` hit, or with seeded
    probability ``prob`` per hit, at most ``times`` times, on hits whose
    context contains every ``match`` value."""

    def __init__(self, site: str, action: str, nth: int | None = None,
                 prob: float | None = None, seed: int | None = None,
                 times: int | None = None, match: dict | None = None,
                 args: dict | None = None):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault prob must be in [0,1], got {prob}")
        self.site = site
        self.action = action
        self.nth = int(nth) if nth is not None else None
        self.prob = float(prob) if prob is not None else None
        self.seed = seed
        self.times = int(times) if times is not None else None
        self.match = dict(match or {})
        self.args = dict(args or {})
        if "errno" in self.args:
            # a misspelt errno fails the arming, not the injection
            self.args["errno"] = resolve_errno(self.args["errno"])
        self._rng = random.Random(seed if seed is not None else 0)
        self._hits = 0
        self._fired = 0
        self._flock = threading.Lock()

    def _matches(self, ctx: dict) -> bool:
        return all(str(needle) in str(ctx.get(key, ""))
                   for key, needle in self.match.items())

    def _eval(self, ctx: dict) -> bool:
        """True when this hit triggers (one decision per hit, under the
        failpoint's own lock)."""
        if not self._matches(ctx):
            return False
        with self._flock:
            self._hits += 1
            if self.times is not None and self._fired >= self.times:
                return False
            if self.nth is not None and self._hits < self.nth:
                return False
            if self.prob is not None and self._rng.random() >= self.prob:
                return False
            if (self.nth is not None and self.prob is None
                    and self.times is None and self._hits > self.nth):
                return False  # a bare nth= fires exactly once
            self._fired += 1
            return True

    def to_json(self) -> dict:
        return {"site": self.site, "action": self.action, "nth": self.nth,
                "prob": self.prob, "seed": self.seed, "times": self.times,
                "match": self.match, "args": self.args,
                "hits": self._hits, "fired": self._fired}


def set_stats(stats) -> None:
    """Wire the metrics sink (the server's Stats registry): every trigger
    counts ``fault_triggered_total{site,action}`` there."""
    global _stats
    _stats = stats


def set_fault(site: str, action: str, **kw) -> dict:
    """Arm a failpoint at ``site`` (several may stack on one site)."""
    global ACTIVE
    fp = Failpoint(site, action, **kw)
    with _lock:
        _registry.setdefault(site, []).append(fp)
        ACTIVE = True
    return fp.to_json()


def clear(site: str | None = None) -> int:
    """Disarm one site's failpoints, or all; returns how many."""
    global ACTIVE
    with _lock:
        if site is None:
            n = sum(len(v) for v in _registry.values())
            _registry.clear()
        else:
            n = len(_registry.pop(site, []))
        ACTIVE = bool(_registry)
    return n


def list_faults() -> list[dict]:
    with _lock:
        return [fp.to_json() for fps in _registry.values() for fp in fps]


def triggered_total() -> dict[tuple[str, str], int]:
    """Triggers so far per ``(site, action)``."""
    with _lock:
        return dict(_triggered)


def reset_triggered() -> None:
    """Zero the trigger counts (test isolation; a live node's are
    cumulative)."""
    with _lock:
        _triggered.clear()


def fire(site: str, **ctx) -> dict | None:
    """Evaluate ``site``'s failpoints against this hit: ``error`` raises,
    ``oom`` raises ``torch.OutOfMemoryError``, ``delay`` sleeps and returns
    its spec, a site-interpreted action returns its spec.  None when
    nothing triggered.  Every trigger counts in :func:`triggered_total`
    and on the wired sink."""
    with _lock:
        fps = list(_registry.get(site, ()))
    for fp in fps:
        if not fp._eval(ctx):
            continue
        with _lock:
            key = (site, fp.action)
            _triggered[key] = _triggered.get(key, 0) + 1
        if _stats is not None:
            _stats.count("fault_triggered_total", 1, site=site,
                         action=fp.action)
        if fp.action == "delay":
            time.sleep(float(fp.args.get("seconds", 0.05)))
            return fp.to_json()
        if fp.action == "error":
            err = FaultError(f"injected fault at {site}")
            if "errno" in fp.args:
                err.errno = fp.args["errno"]
                err.strerror = f"injected fault at {site}"
            raise err
        if fp.action != "oom":
            return fp.to_json()  # site-interpreted
        import torch
        raise torch.OutOfMemoryError(
            f"CUDA out of memory: injected fault at {site}")
    return None


def torn_write(f, data: bytes, spec: dict) -> None:
    """Apply a triggered ``torn_write``: persist only the first
    ``args.offset`` bytes of ``data`` to the open file, flush, and raise
    :class:`FaultError` (the crash).  Every write seam shares it."""
    args = spec.get("args", {})
    off = min(int(args.get("offset", 0)), len(data))
    f.write(data[:off])
    f.flush()
    err = FaultError(
        f"injected torn write: {off}/{len(data)} bytes persisted")
    if "errno" in args:
        err.errno = resolve_errno(args["errno"])
    raise err


def configure(spec: str | list | dict | None) -> int:
    """Arm failpoints from a JSON list of spec objects (the reference's
    ``PILOSA_FAULTS`` format); returns the number armed."""
    if not spec:
        return 0
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"fault spec is not valid JSON: {e}")
    if isinstance(spec, dict):
        spec = [spec]
    n = 0
    for entry in spec:
        entry = dict(entry)
        site = entry.pop("site", None)
        action = entry.pop("action", None)
        if not site or not action:
            raise ValueError(f"fault spec requires site and action: {entry}")
        set_fault(site, action, **entry)
        n += 1
    return n
