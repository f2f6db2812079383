"""Device health governor: the batcher's healthy -> degraded -> probing
breaker (``pilosa_tpu.exec.health``).

The batcher is one shared device stream: a sick card (a launch that is
refused, a window that never finishes) would poison every request riding
it.  The governor watches the batcher's two fault signals, consecutive
launch faults and watchdog trips, and flips serving to DEGRADED: the solo
fast lane off, readback pipelining off, and every window served inline
one item at a time through the same hand kernels.  After
``probe_after_s`` one window is admitted back onto the pipeline as a
PROBE: success returns to HEALTHY, a fault degrades again and schedules
the next probe.

The happy path is lock-free: ``admit``, ``fastlane_ok`` and
``record_success`` read one attribute while the state is HEALTHY with no
fault outstanding.
"""

from __future__ import annotations

import threading
import time

HEALTHY = "healthy"
DEGRADED = "degraded"
PROBING = "probing"

# the ``stateCode`` of the /status deviceHealth block
STATE_CODE = {HEALTHY: 0, DEGRADED: 1, PROBING: 2}


class DeviceHealthGovernor:
    """Consecutive-fault breaker for the batcher's device pipeline.

    - ``record_fault()``: a window's launch (or a fast-lane launch)
      raised.  ``FAULT_THRESHOLD`` consecutive faults degrade; a fault
      during a probe degrades again at once.
    - ``record_trip()``: the watchdog quarantined a window: degrade at
      once.
    - ``record_success()``: a window finished cleanly; resets the
      streak, and a successful PROBE restores HEALTHY.
    - ``admit()``: may this window use the pipeline?  HEALTHY: yes.
      DEGRADED: no, until ``probe_after_s`` has passed; then ONE window
      is admitted as the probe (PROBING) and the others wait for its
      verdict.

    Every transition sets the ``device_health_state`` gauge (0 healthy,
    1 degraded, 2 probing) and lands on the flight recorder; a degrade
    also dumps the ring (the run-up to the breaker opening is the
    postmortem)."""

    FAULT_THRESHOLD = 3

    def __init__(self, probe_after_s: float = 5.0, tier: str = "cuda",
                 stats=None, flight=None):
        from pilosa_tpu_torch.obs import NULL_FLIGHT, NopStats
        self._stats = stats or NopStats()
        self.flight = flight or NULL_FLIGHT
        self.tier = tier
        self.probe_after_s = max(0.05, float(probe_after_s))
        self._state = HEALTHY
        self._consecutive = 0
        self._since = time.monotonic()  # last transition
        self._trips = 0
        self._faults_total = 0
        self._lock = threading.Lock()

    # -- hot-path reads (lock-free) ----------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def fastlane_ok(self) -> bool:
        """The solo fast lane runs only while HEALTHY: a degraded or
        probing card must not launch on callers' threads, where a hang
        wedges a thread the watchdog cannot reclaim."""
        return self._state == HEALTHY

    def pipelining_ok(self) -> bool:
        """Readback run-ahead only while HEALTHY: degraded and probe
        windows finish inline, one at a time."""
        return self._state == HEALTHY

    # -- events ------------------------------------------------------------

    def _transition(self, to: str) -> None:
        """Caller holds the lock."""
        came = self._state
        self._state = to
        self._since = time.monotonic()
        self._stats.gauge("device_health_state", STATE_CODE[to])
        self.flight.record("governor", "device", f"{came}->{to}")
        if to == DEGRADED:
            self.flight.incident("governor_degrade", "device",
                                 f"from {came}")

    def record_fault(self) -> None:
        with self._lock:
            self._consecutive += 1
            self._faults_total += 1
            if self._state == PROBING:
                self._transition(DEGRADED)
            elif (self._state == HEALTHY
                  and self._consecutive >= self.FAULT_THRESHOLD):
                self._transition(DEGRADED)

    def record_trip(self) -> None:
        with self._lock:
            self._trips += 1
            self._consecutive = 0  # a hang resets the error streak
            if self._state != DEGRADED:
                self._transition(DEGRADED)

    def record_success(self) -> None:
        if self._state == HEALTHY and self._consecutive == 0:
            return  # lock-free happy path
        with self._lock:
            self._consecutive = 0
            if self._state == PROBING:
                self._transition(HEALTHY)

    def admit(self) -> bool:
        """True = this window may use the pipeline."""
        if self._state == HEALTHY:
            return True  # lock-free happy path
        with self._lock:
            if self._state == HEALTHY:
                return True
            if (self._state == DEGRADED
                    and time.monotonic() - self._since
                    >= self.probe_after_s):
                self._transition(PROBING)
                return True  # this window is the probe
            return False

    # -- introspection -----------------------------------------------------

    def payload(self) -> dict:
        """The governor's part of the ``/status`` deviceHealth block."""
        with self._lock:
            return {
                "state": self._state,
                "stateCode": STATE_CODE[self._state],
                "consecutiveFaults": self._consecutive,
                "faultsTotal": self._faults_total,
                "watchdogTrips": self._trips,
                "sinceSeconds": round(time.monotonic() - self._since, 3),
                "probeAfterSeconds": self.probe_after_s,
                "faultThreshold": self.FAULT_THRESHOLD,
                "kernelTier": self.tier,
            }
