"""Per-tenant admission quotas (``pilosa_tpu.tenancy.qos``).

Tenant = index name.  Both quotas are off by default:

- a qps quota: a token bucket per tenant holding one second of quota,
  refilled continuously;
- a slot quota: at most this many of the tenant's queries execute at
  once.

A query over quota raises :class:`TenantThrottledError` before it takes
an executor slot; the API answers it with a 503, a ``Retry-After`` header
and a ``tenantThrottled{tenant, quota, kind}`` body.  The reference's
third quota, device seconds, reads its cost ledger, which this port does
not have.
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
        self.kind = kind  # "qps" | "slots"
        self.retry_after = retry_after


class TenantQos:
    """Per-tenant admission state under one lock."""

    def __init__(self, qps_quota: float = 0.0, slot_quota: int = 0):
        self.qps_quota = float(qps_quota)
        self.slot_quota = int(slot_quota)
        self._lock = threading.Lock()
        self._buckets: dict[str, list] = {}   # tenant -> [tokens, ts]
        self._inflight: dict[str, int] = {}
        self._sheds: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.qps_quota > 0 or self.slot_quota > 0

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
                    "deviceSecondsQuota": 0.0,
                    "inflight": dict(self._inflight),
                    "sheds": dict(self._sheds),
                    "shedTotal": int(sum(self._sheds.values()))}
