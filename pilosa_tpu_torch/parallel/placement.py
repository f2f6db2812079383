"""Shard -> partition -> node placement (``pilosa_tpu.parallel.
placement``'s): a shard hashes to one of 256 partitions by jump
consistent hash of (index, shard), and a partition maps to ``replicas``
nodes, the primary picked by jump hash among the sorted node ids and the
replicas following in ring order.  Placement depends on the node ids'
sort order alone, so two clusters whose ids sort alike place every shard
on the same node position.

Jump hash per Lamping & Veach, "A Fast, Minimal Memory, Consistent Hash
Algorithm".
"""

from __future__ import annotations

from pilosa_tpu_torch.store.translate import PARTITION_N, fnv1a64


def jump_hash(key: int, n_buckets: int) -> int:
    """Jump consistent hash: uint64 key -> bucket in [0, n_buckets)."""
    if n_buckets <= 0:
        raise ValueError("n_buckets must be positive")
    b, j = -1, 0
    key &= 0xFFFFFFFFFFFFFFFF
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def shard_partition(index: str, shard: int,
                    n_partitions: int = PARTITION_N) -> int:
    """Partition of (index, shard): the fnv hash of the index name and the
    big-endian shard, jump-hashed."""
    h = fnv1a64(index.encode() + shard.to_bytes(8, "big"))
    return jump_hash(h, n_partitions)


def partition_nodes(partition: int, node_ids: list[str],
                    replica_n: int = 1) -> list[str]:
    """The ``replica_n`` nodes owning a partition, primary first."""
    if not node_ids:
        return []
    nodes = sorted(node_ids)
    k = min(replica_n, len(nodes))
    start = jump_hash(partition, len(nodes))
    return [nodes[(start + i) % len(nodes)] for i in range(k)]


def shard_nodes(index: str, shard: int, node_ids: list[str],
                replica_n: int = 1) -> list[str]:
    """Owning nodes of a shard, primary first."""
    return partition_nodes(shard_partition(index, shard), node_ids,
                           replica_n)
