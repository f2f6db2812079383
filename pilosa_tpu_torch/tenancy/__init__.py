"""Multi-tenant residency (tenant = index name), after
``pilosa_tpu.tenancy``:

- :mod:`~pilosa_tpu_torch.tenancy.paging`: a plane past the device budget
  (or its tenant's byte quota) is served in shard pages, each an ordinary
  plane-cache entry; resident pages answer on the card, the host's row
  cardinalities answer the rest, exactly;
- :mod:`~pilosa_tpu_torch.tenancy.governor`: the eviction order (decayed
  hits x bytes x rebuild seconds, least recently used as the tie-break)
  and the per-tenant byte quota that gates page-ins;
- :mod:`~pilosa_tpu_torch.tenancy.qos`: per-tenant qps and in-flight
  quotas, shed with a structured 503 before a query takes a slot.
"""

from pilosa_tpu_torch.tenancy.governor import ResidencyGovernor
from pilosa_tpu_torch.tenancy.paging import PlanePager
from pilosa_tpu_torch.tenancy.qos import TenantQos, TenantThrottledError

__all__ = ["ResidencyGovernor", "PlanePager", "TenantQos",
           "TenantThrottledError"]
