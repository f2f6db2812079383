"""Per-tenant admission quotas (``pilosa_tpu.tenancy.qos``).

Tenant = index name.  The three quotas are off by default:

- a qps quota: a token bucket per tenant holding one second of quota,
  refilled continuously;
- a slot quota: at most this many of the tenant's queries execute at
  once;
- a device-seconds quota: a tenant whose decayed recent device seconds
  (the cost ledger's :meth:`~pilosa_tpu_torch.obs.ledger.CostLedger.
  recent_seconds`) reach the quota sheds until the window decays back
  under it, whatever its request rate.

A query over quota raises :class:`TenantThrottledError` before it takes
an executor slot; the API answers it with a 503, a ``Retry-After`` header
and a ``tenantThrottled{tenant, quota, kind}`` body.  Each shed counts on
``tenant_shed_total{tenant}``.
"""

from __future__ import annotations

import threading
import time


class TenantThrottledError(Exception):
    """A tenant over its qps or slot quota was shed.  Not an
    ``ExecutionError``: the API's generic 400 must never catch it."""

    def __init__(self, msg: str, tenant: str, quota: float,
                 kind: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.quota = quota
        self.kind = kind  # "qps" | "slots" | "device-seconds"
        self.retry_after = retry_after


class TenantQos:
    """Per-tenant admission state under one lock."""

    def __init__(self, qps_quota: float = 0.0, slot_quota: int = 0,
                 stats=None, device_seconds_quota: float = 0.0,
                 ledger=None):
        from pilosa_tpu_torch.obs import NopStats
        self.qps_quota = float(qps_quota)
        self.slot_quota = int(slot_quota)
        self.device_seconds_quota = float(device_seconds_quota)
        self._ledger = ledger
        self._stats = stats or NopStats()
        self._lock = threading.Lock()
        self._buckets: dict[str, list] = {}   # tenant -> [tokens, ts]
        self._inflight: dict[str, int] = {}
        self._sheds: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return (self.qps_quota > 0 or self.slot_quota > 0
                or (self.device_seconds_quota > 0
                    and self._ledger is not None))

    def admit(self, tenant: str) -> None:
        """Admit one query of ``tenant`` or raise
        :class:`TenantThrottledError`; an admitted query is paired with
        :meth:`release`."""
        now = time.monotonic()
        with self._lock:
            if self.qps_quota > 0:
                burst = max(1.0, self.qps_quota)
                tok, last = self._buckets.get(tenant, (burst, now))
                tok = min(burst, tok + (now - last) * self.qps_quota)
                if tok < 1.0:
                    self._buckets[tenant] = [tok, now]
                    self._shed(tenant, self.qps_quota, "qps",
                               retry_after=(1.0 - tok) / self.qps_quota)
                self._buckets[tenant] = [tok - 1.0, now]
            if self.slot_quota > 0:
                used = self._inflight.get(tenant, 0)
                if used >= self.slot_quota:
                    self._shed(tenant, self.slot_quota, "slots",
                               retry_after=0.5)
                self._inflight[tenant] = used + 1
            if self.device_seconds_quota > 0 and self._ledger is not None:
                spent = self._ledger.recent_seconds(tenant)
                if spent >= self.device_seconds_quota:
                    self._inflight_undo(tenant)
                    self._shed(tenant, self.device_seconds_quota,
                               "device-seconds", retry_after=1.0)

    def _inflight_undo(self, tenant: str) -> None:
        """Caller holds the lock: give back the slot this admit just
        took before a later quota sheds (a raising admit is never paired
        with :meth:`release`)."""
        if self.slot_quota <= 0:
            return
        left = self._inflight.get(tenant, 0) - 1
        if left > 0:
            self._inflight[tenant] = left
        else:
            self._inflight.pop(tenant, None)

    def release(self, tenant: str) -> None:
        if self.slot_quota <= 0:
            return
        with self._lock:
            left = self._inflight.get(tenant, 0) - 1
            if left > 0:
                self._inflight[tenant] = left
            else:
                self._inflight.pop(tenant, None)

    def _shed(self, tenant: str, quota: float, kind: str,
              retry_after: float) -> None:
        # caller holds self._lock
        self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
        self._stats.count("tenant_shed_total", 1, tenant=tenant)
        raise TenantThrottledError(
            f"tenant {tenant!r} over its {kind} quota ({quota:g}); "
            f"retry later", tenant, quota, kind,
            retry_after=max(0.05, retry_after))

    def forget(self, tenant: str) -> None:
        """Drop a deleted tenant's token bucket and shed count (its
        in-flight queries still release their slots)."""
        with self._lock:
            self._buckets.pop(tenant, None)
            self._sheds.pop(tenant, None)

    def sheds(self, tenant: str) -> int:
        return self._sheds.get(tenant, 0)

    def payload(self) -> dict:
        """The ``/status`` tenancy block's QoS half."""
        with self._lock:
            return {"qpsQuota": self.qps_quota,
                    "slotQuota": self.slot_quota,
                    "deviceSecondsQuota": self.device_seconds_quota,
                    "inflight": dict(self._inflight),
                    "sheds": dict(self._sheds),
                    "shedTotal": int(sum(self._sheds.values()))}
