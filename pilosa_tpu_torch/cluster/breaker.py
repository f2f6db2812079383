"""Per-peer circuit breakers for the cluster client layer
(``pilosa_tpu.cluster.breaker``'s).

``breaker_threshold`` CONSECUTIVE transport failures (connection
refused/reset, TLS alert — the peer never answered a request) open a
peer's breaker.  An open peer is skipped at read-routing time: the
fan-out goes straight to a live replica instead of paying a
connect-timeout tax on every query that touches the sick peer's
shards.  Half-open probes ride the existing heartbeat loop — each
round, an OPEN breaker steps to HALF_OPEN for the duration of that
round's heartbeat to the peer; a successful heartbeat (or any
successful request) closes it, a failure re-opens it immediately.

State is exported per peer: a ``peer_breaker_state`` gauge (0 closed,
1 half-open, 2 open), a ``breaker_transitions_total{peer,from,to}``
counter, and the ``clusterHealth`` block on ``/status``.

Scope: the breaker is an AVAILABILITY optimization, never a
correctness gate — the router falls back to an open peer when no
healthy replica remains, and the write path's strict semantics
(``dist._write``) never consult it.
"""

from __future__ import annotations

import threading

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

# gauge encoding for peer_breaker_state
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerBoard:
    """All peers' breakers behind one lock (membership is a handful of
    nodes; contention is nil next to the I/O the breaker guards)."""

    def __init__(self, threshold: int = 3, stats=None, logger=None):
        self.threshold = max(1, int(threshold))
        self._stats = stats
        self._logger = logger
        self._lock = threading.Lock()
        self._state: dict[str, str] = {}
        self._fails: dict[str, int] = {}

    # -- introspection -------------------------------------------------------

    def state(self, peer: str) -> str:
        with self._lock:
            return self._state.get(peer, CLOSED)

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._state)

    def unhealthy_peers(self) -> set[str]:
        """Peers the read router should avoid: open, or mid-probe
        (half-open lets exactly the heartbeat probe through — a query
        racing the probe must not pile onto a still-sick peer)."""
        with self._lock:
            return {p for p, s in self._state.items() if s != CLOSED}

    # -- outcome recording ---------------------------------------------------

    def record_success(self, peer: str) -> None:
        """Any answered request (HTTP errors included: the peer is
        alive) resets the failure streak and closes the breaker."""
        with self._lock:
            self._fails[peer] = 0
            old = self._state.get(peer, CLOSED)
            if old != CLOSED:
                self._state[peer] = CLOSED
        if old != CLOSED:
            self._transition(peer, old, CLOSED)

    def record_failure(self, peer: str) -> None:
        """One transport failure.  Opens from CLOSED at the threshold;
        a HALF_OPEN probe failure re-opens immediately."""
        with self._lock:
            n = self._fails.get(peer, 0) + 1
            self._fails[peer] = n
            old = self._state.get(peer, CLOSED)
            new = old
            if old == HALF_OPEN or (old == CLOSED and n >= self.threshold):
                new = self._state[peer] = OPEN
        if new != old:
            self._transition(peer, old, new)

    def begin_probe(self, peer: str) -> bool:
        """OPEN → HALF_OPEN for one probe (the heartbeat loop calls
        this just before heartbeating the peer).  Returns whether a
        probe was actually begun."""
        with self._lock:
            if self._state.get(peer, CLOSED) != OPEN:
                return False
            self._state[peer] = HALF_OPEN
        self._transition(peer, OPEN, HALF_OPEN)
        return True

    def reset(self, peer: str) -> None:
        """Forget a peer's history (explicit rejoin: the node came back
        through the membership path, which is stronger evidence than
        any probe — it must be immediately routable again)."""
        with self._lock:
            old = self._state.pop(peer, CLOSED)
            self._fails.pop(peer, None)
        if old != CLOSED:
            self._transition(peer, old, CLOSED)

    # -- export --------------------------------------------------------------

    def _transition(self, peer: str, old: str, new: str) -> None:
        if self._logger is not None:
            log = (self._logger.warning if new == OPEN
                   else self._logger.info)
            log("peer breaker %s: %s -> %s", peer, old, new)
        if self._stats is not None:
            self._stats.gauge("peer_breaker_state", STATE_CODES[new],
                              peer=peer)
            self._stats.count("breaker_transitions_total", 1, peer=peer,
                              **{"from": old, "to": new})
