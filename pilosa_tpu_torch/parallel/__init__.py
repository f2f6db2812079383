"""Host-level shard placement across a cluster's nodes
(``pilosa_tpu.parallel``'s jump-hash half; its meshed half waits for
multi-device serving)."""

from pilosa_tpu_torch.parallel.placement import (jump_hash, partition_nodes,
                                                 shard_nodes, shard_partition)

__all__ = ["jump_hash", "shard_partition", "partition_nodes", "shard_nodes"]
