"""Distribution: a plane's shard axis in blocks over the local devices
(``parallel.mesh``, with the programs of ``parallel.spmd``), those blocks
joined across processes in one ``torch.distributed`` process group
(``parallel.multiproc``), and host-level shard placement across a
cluster's nodes by jump hash (``parallel.placement``, loaded on first
use: it reads the store's hash, and the engine imports ``parallel.mesh``
before the store exists)."""

from pilosa_tpu_torch.parallel.mesh import (MeshPlacement, MeshPlacement2D,
                                            local_placement)

_PLACEMENT = ("jump_hash", "shard_partition", "partition_nodes",
              "shard_nodes")

__all__ = ["MeshPlacement", "MeshPlacement2D", "local_placement",
           *_PLACEMENT]


def __getattr__(name: str):
    if name in _PLACEMENT:
        from pilosa_tpu_torch.parallel import placement
        return getattr(placement, name)
    raise AttributeError(name)
