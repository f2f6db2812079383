"""The cluster (``pilosa_tpu.cluster``'s): membership, placement,
distributed queries, replicated writes with hinted handoff,
anti-entropy, resize and replica repair, every node serving its own
shards through its own executor on the card."""

from pilosa_tpu_torch.cluster.cluster import (STATE_DEGRADED, STATE_NORMAL,
                                              STATE_RESIZING, STATE_STARTING,
                                              Cluster)
from pilosa_tpu_torch.cluster.dist import DistributedExecutor, merge_results

__all__ = [
    "Cluster", "DistributedExecutor", "merge_results",
    "STATE_STARTING", "STATE_NORMAL", "STATE_RESIZING", "STATE_DEGRADED",
]
