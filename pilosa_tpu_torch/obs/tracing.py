"""Tracing: spans over the query pipeline (``pilosa_tpu.obs.tracing``'s).

An explicit span tree per query, the W3C-style ``traceparent`` header
(:func:`parse_traceparent`, :meth:`Tracer.inject` / :meth:`Tracer.extract`)
and an in-memory ring of finished traces served at ``GET /internal/traces``
(``?trace_id=`` looks one up) and in ``?profile`` query responses.  Span
children are :class:`Span` objects or already-serialized dicts (a subtree
grafted from elsewhere passes through :meth:`Span.to_json` as is).

Slow queries land in :class:`SlowQueryLog`, a bounded ring of (PQL,
index, shards, duration, span tree) records behind ``GET /debug/slow``.
"""

from __future__ import annotations

import random
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field as dc_field

TRACEPARENT = "Traceparent"  # traceparent: 00-<trace_id>-<span_id>-01


# span/trace ids need uniqueness, not cryptographic strength — the
# original secrets.token_hex path cost one urandom syscall per id
# (several ids per query).  Per-thread PRNGs seeded from urandom
# once keep ids unique across threads without sharing generator state.
_id_tls = threading.local()


def _id_rng() -> random.Random:
    r = getattr(_id_tls, "rng", None)
    if r is None:
        r = _id_tls.rng = random.Random(secrets.token_bytes(16))
    return r


def fast_trace_id() -> str:
    return f"{_id_rng().getrandbits(64):016x}"


def fast_span_id() -> str:
    return f"{_id_rng().getrandbits(32):08x}"


# The ACTIVE trace id of the request this thread is serving (set by
# the API edge for every query — lite or traced — and by the internal
# fan-out handler for propagated legs).  The JSON log formatter reads
# it, so any log line emitted while serving a request carries the same
# id its latency exemplar and span tree do: one id joins all three.
_active = threading.local()


def set_current_trace_id(trace_id: str | None) -> None:
    _active.trace_id = trace_id


def current_trace_id() -> str | None:
    return getattr(_active, "trace_id", None)


_HEX = frozenset("0123456789abcdefABCDEF")


def parse_traceparent(value: str | None) \
        -> tuple[str, str, str] | None:
    """Validated ``(trace_id, parent_span_id, flags)`` from a
    traceparent header, or None for anything malformed: wrong segment
    count, empty ids, non-hex ids.  The caller falls back to a fresh
    root span — a garbage header from an arbitrary peer must never
    raise, and must never be accepted as a trace identity (it would
    alias unrelated traces in the finished ring).  Hex validation is
    by character set, NOT ``int(x, 16)`` — the int parser's literal
    quirks (underscores, signs, whitespace) are not hex ids.

    ``flags`` carries the coordinator's materialize + retain
    decisions: "01" = sampled/profiled — build the subtree, ship it
    back, AND keep a copy in the local ring; "02" = slow-hunt — build
    and ship the subtree but do NOT churn the local ring; "00" (or
    anything else) = the coordinator runs the lite path and will never
    materialize a tree — serve under NULL_TRACER, build nothing, ship
    nothing."""
    if not value:
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, flags = parts
    if not trace_id or not span_id:
        return None
    if not (set(trace_id) <= _HEX and set(span_id) <= _HEX):
        return None
    return trace_id, span_id, flags


@dataclass(slots=True)
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start: float = 0.0
    duration: float = 0.0
    tags: dict = dc_field(default_factory=dict)
    # Span children for spans opened on this node; grafted remote
    # subtrees are appended as already-serialized dicts (to_json output
    # of the peer's continuation span)
    children: list = dc_field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "name": self.name, "durationUs": round(self.duration * 1e6),
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id,
            "tags": self.tags,
            "children": [c.to_json() if isinstance(c, Span) else c
                         for c in self.children],
        }


class Tracer:
    """Per-process tracer.  ``span()`` nests via a thread-local stack;
    ``extract``/``inject`` carry the active trace across nodes."""

    def __init__(self, keep: int = 128):
        self._local = threading.local()
        self._finished: deque[Span] = deque(maxlen=keep)
        self._lock = threading.Lock()

    def _stack(self) -> list[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current_span(self) -> Span | None:
        """The innermost open span on THIS thread (None outside any)."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, **tags):
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(
            name=name,
            trace_id=parent.trace_id if parent else fast_trace_id(),
            span_id=fast_span_id(),
            parent_id=parent.span_id if parent else None,
            start=time.perf_counter(),
            tags=tags,
        )
        stack.append(s)
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - s.start
            stack.pop()
            if parent is not None:
                parent.children.append(s)
            else:
                with self._lock:
                    self._finished.append(s)

    def stage(self, name: str, duration: float, **tags) -> None:
        """Attach an already-timed child span (a StageTimer mark) to the
        innermost open span on this thread; no-op outside any span —
        per-stage attribution only makes sense inside a traced query."""
        parent = self.current_span()
        if parent is None:
            return
        parent.children.append(Span(
            name=name, trace_id=parent.trace_id,
            span_id=fast_span_id(), parent_id=parent.span_id,
            duration=duration, tags=tags))

    # -- cross-node propagation (reference: handler extract / client inject)

    def inject(self, headers: dict, span: Span | None = None,
               sampled: bool = True) -> None:
        """Write the active trace identity into ``headers``.  ``span``
        overrides the thread-local stack — fan-out legs run on pool
        threads where the coordinator's stack is not visible, so the
        dispatching thread captures its span first.

        The flags segment carries TWO decisions to the peer:
        ``sampled=True`` -> "01" (materialize the subtree, ship it
        back, AND keep a copy in your own finished ring);
        ``sampled=False`` -> "02" (materialize and ship — the
        coordinator may yet capture a SLOW trace that needs your
        subtree — but do NOT churn your ring for a trace that is
        99%-likely discarded).  Lite-path queries never reach this
        method; :class:`LiteTracer` injects flags "00" (build
        nothing)."""
        s = span if span is not None else self.current_span()
        if s is not None:
            flags = "01" if sampled else "02"
            headers[TRACEPARENT] = f"00-{s.trace_id}-{s.span_id}-{flags}"

    @contextmanager
    def extract(self, headers, name: str, **tags):
        """Open a span continuing the trace in ``headers`` (if any).
        Malformed or garbage traceparent values (wrong segment count,
        non-hex ids) fall back to a fresh root span — never an
        exception, never a fabricated trace identity."""
        tp = headers.get(TRACEPARENT) or headers.get(TRACEPARENT.lower())
        parsed = parse_traceparent(tp)
        if parsed is not None:
            trace_id, parent_id, _ = parsed
            remote = Span(name="remote-parent", trace_id=trace_id,
                          span_id=parent_id, parent_id=None)
            self._stack().append(remote)
            try:
                with self.span(name, **tags) as s:
                    yield s
            finally:
                self._stack().pop()
                # the synthetic parent is discarded; its real children
                # are this node's roots for the propagated trace
                with self._lock:
                    self._finished.extend(remote.children)
            return
        with self.span(name, **tags) as s:
            yield s

    def record(self, span: Span) -> None:
        """Publish a finished root span into this tracer's ring —
        per-request tracers hand their retained roots to the process
        GLOBAL_TRACER here, so ``/internal/traces?trace_id=`` resolves
        them after the request is gone."""
        with self._lock:
            self._finished.append(span)

    def finished(self) -> list[Span]:
        with self._lock:
            return list(self._finished)


class _NullSpanCtx:
    """Reusable no-op context manager: the span surface of the lite
    path.  ``__enter__`` yields None — every ``with tracer.span(...)``
    on the serving path uses the span positionally (no ``as``) or
    tolerates None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """Tracer surface with zero per-call allocation — what a peer runs
    under when the coordinator's traceparent flags say the trace will
    never be materialized (``00``).  No spans, no ids, no ring."""

    __slots__ = ()
    sampled = False

    def span(self, name, **tags):
        return _NULL_CTX

    def stage(self, name, duration, **tags):
        pass

    def current_span(self):
        return None

    def inject(self, headers, span=None, sampled=False):
        pass

    def finished(self):
        return []

    def record(self, span):
        pass


NULL_TRACER = NullTracer()


class LiteTracer(NullTracer):
    """Trace IDENTITY without a span tree.

    The retention decision (sampling / profile / slow-hunt threshold)
    is made BEFORE any span materializes; queries that lose it run
    under this: a per-request trace id for the ``X-Pilosa-Trace-Id``
    header and cross-node propagation (flags ``00`` — peers run under
    :data:`NULL_TRACER`), plus a plain ``marks`` list the StageTimer
    appends (name, seconds) tuples into, so a query that turns out SLOW
    can still be captured with its per-stage breakdown.  Everything
    else — span objects, id generation per span, ring churn — is
    skipped entirely."""

    __slots__ = ("trace_id", "marks")

    def __init__(self, trace_id: str | None = None):
        self.trace_id = trace_id or fast_trace_id()
        self.marks: list[tuple[str, float]] = []

    def stage(self, name, duration, **tags):
        self.marks.append((name, duration))

    def inject(self, headers, span=None, sampled=False):
        # propagate identity so peers neither invent a fresh root nor
        # churn their rings; flags "00" = the tree is never built
        headers[TRACEPARENT] = f"00-{self.trace_id}-00000000-00"

    def slow_root(self, name: str, duration: float, **tags) -> Span:
        """Materialize a minimal root for slow-query capture AFTER the
        fact: the request's stage marks become ``stage.*`` children.
        This is the degraded (but still attributable) tree an
        unsampled slow query gets; full executor-span trees need the
        query to be sampled, profiled, or the slow threshold set at or
        under the API's ``SLOW_TRACE_FLOOR``."""
        root = Span(name=name, trace_id=self.trace_id,
                    span_id=fast_span_id(), parent_id=None,
                    duration=duration, tags=tags)
        for mark, dur in self.marks:
            root.children.append(Span(
                name=mark, trace_id=self.trace_id,
                span_id=fast_span_id(), parent_id=root.span_id,
                duration=dur))
        return root


class SlowQueryLog:
    """Bounded ring of slow-query records: PQL, index, shards,
    duration, trace id and the full span tree.  ``total`` keeps
    counting past the ring bound (the ring is a sample, the counter is
    the truth — same split as prometheus counter vs. exemplars)."""

    def __init__(self, keep: int = 64):
        self._entries: deque[dict] = deque(maxlen=keep)
        self._lock = threading.Lock()
        self._total = 0

    def record(self, entry: dict) -> None:
        with self._lock:
            self._total += 1
            self._entries.append(entry)

    def entries(self) -> list[dict]:
        """Newest first (the one an operator is chasing is recent)."""
        with self._lock:
            return list(reversed(self._entries))

    def summary(self) -> dict:
        with self._lock:
            slowest = max((e.get("durationMs", 0.0)
                           for e in self._entries), default=0.0)
            return {"total": self._total, "kept": len(self._entries),
                    "slowestMs": slowest}


GLOBAL_TRACER = Tracer()
