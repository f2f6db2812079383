"""Virtual placements: n blocks over one device.

The counterpart of ``pilosa_tpu.virtmesh``.  The reference validates its
distribution path on an n-device virtual CPU mesh; the port's counterpart
is a placement whose blocks all live on one torch device, ``"cpu"`` in
the tests and ``"cuda:0"`` on a single card, so the blocked planes, the
per-block launches (each block on its own CUDA stream) and the gathers run
as they would over n cards.  The reference's ``force_virtual_cpu_mesh``
recipe (retargeting JAX's backend before it initializes) has no torch
meaning and is not ported.
"""

from __future__ import annotations

from pilosa_tpu_torch.engine import resolve_device
from pilosa_tpu_torch.parallel.mesh import MeshPlacement


def virtual_placement(n_devices: int, device=None) -> MeshPlacement:
    """A 1-D placement of ``n_devices`` blocks, all on ``device`` (None:
    the CUDA device; the CPU only when asked for by name)."""
    if n_devices < 1:
        raise ValueError("a virtual placement needs at least one block")
    return MeshPlacement([resolve_device(device)] * n_devices)
