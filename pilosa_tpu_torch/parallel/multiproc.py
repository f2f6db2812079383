"""Several processes in one ``torch.distributed`` process group: the
counterpart of the reference's multi-process JAX runtime
(``jax.distributed.initialize``, a mesh over every process's devices and
``jax.make_array_from_process_local_data``).

:func:`join` makes this process one rank of the group: NCCL when it
serves on a CUDA device (the process's first card made current first,
and passed as ``device_id``, so the communicator forms at the join), gloo
only when the caller asks for the CPU, as the tests do.  The device
decides the backend; there is no switch and no fallback, and a failed
init raises.  A peer that never joins makes :func:`join` raise after
``timeout`` seconds (``JOIN_TIMEOUT_S`` by default) rather than hang the
boot.  Where the reference leaves the process count and index to JAX's
detection (``jax_num_processes = 0``, ``jax_process_id = -1``), the port
reads torchrun's ``WORLD_SIZE`` and ``RANK``.

:class:`ProcessPlacement` is this process's local placement (a
:class:`~pilosa_tpu_torch.parallel.mesh.MeshPlacement` or
:class:`~pilosa_tpu_torch.parallel.mesh.MeshPlacement2D` over its own
devices) joined with the group.  Global shard blocks run in rank-major
order: process ``p`` holds global blocks ``[p*k, (p+1)*k)`` of ``k``
local ones, the layout of the reference's ``P("shard")`` over
``jax.devices()``.  :meth:`ProcessPlacement.place` builds this process's
blocks from its own rows only; no process holds another's.  A
:class:`~pilosa_tpu_torch.parallel.mesh.Blocked` over it reduces across
processes: ``total`` sums locally then runs one all-reduce over the
group, ``gather`` and ``full`` concatenate locally then all-gather in
rank order, so every process holds the same answer.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from pilosa_tpu_torch.engine import resolve_device
from pilosa_tpu_torch.parallel.mesh import Blocked, _Placement

JOIN_TIMEOUT_S = 120.0   # seconds a join (and a collective) may wait
_LEFT = "pilosa/left"     # the store's count of ranks that left

# the reference's "detect it" defaults, and the variables read instead
_DETECT = {"jax_num_processes": (0, "WORLD_SIZE"),
           "jax_process_id": (-1, "RANK")}


def _detected(key: str, value: int) -> int:
    """``value``, or torchrun's variable when it is the reference's
    "detect it" default; ``ValueError`` naming ``key`` when neither
    gives one."""
    default, var = _DETECT[key]
    if value != default:
        return int(value)
    got = os.environ.get(var)
    if got is None:
        raise ValueError(f"config key {key} is not set and ${var} is not "
                         "in the environment: give the key a value or "
                         "start the process under torchrun")
    return int(got)


class Group:
    """This process's rank in the joined process group and the group's
    two collectives, each on the current stream of the tensor's device.
    ``store`` is the rendezvous store, hosted by rank 0."""

    def __init__(self, rank: int, size: int, backend: str,
                 device: torch.device, store, timeout: float):
        self.rank, self.size = rank, size
        self.backend, self.device = backend, device
        self.store, self.timeout = store, timeout

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every process (one all-reduce, into a copy)."""
        out = t.clone(memory_format=torch.contiguous_format)
        with _on(out.device):
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def cat(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``t`` (alike in shape) concatenated along
        ``dim`` in rank order (one all-gather)."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        with _on(t.device):
            dist.all_gather_into_tensor(out, t)
        return out if dim == 0 else torch.cat(out.chunk(self.size), dim)

    def leave(self) -> None:
        """Destroy the process group (this process may join again).  Rank
        0 hosts the rendezvous store, so it returns only once every rank
        has left (or ``timeout`` passed): a peer's shutdown still reads
        the store, and NCCL's watchdog warns of a store gone early."""
        if self.store is None:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        self.store.add(_LEFT, 1)
        end = time.monotonic() + self.timeout
        while (self.rank == 0 and self.store.add(_LEFT, 0) < self.size
               and time.monotonic() < end):
            time.sleep(0.05)
        self.store = None

    def __repr__(self) -> str:
        return (f"Group(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


def _on(device: torch.device):
    """The device context a collective runs under (its current stream)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def join(coordinator: str, num_processes: int = 0, process_id: int = -1,
         device=None, timeout: float = JOIN_TIMEOUT_S) -> Group:
    """Join the process group whose rank 0 listens at ``coordinator``
    (``host:port``) as process ``process_id`` of ``num_processes``.  On a
    CUDA ``device`` (None: the CUDA device) the backend is NCCL, on the
    CPU gloo.  Raises ``ValueError`` for a missing or impossible count or
    index, and whatever the rendezvous (a ``TCPStore`` that rank 0
    hosts) or ``init_process_group`` raises, a peer missing past
    ``timeout`` seconds among it."""
    size = _detected("jax_num_processes", num_processes)
    rank = _detected("jax_process_id", process_id)
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"process {rank} of {size} is not a rank of a "
                         "process group (jax_process_id must lie in "
                         "[0, jax_num_processes))")
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    dev = resolve_device(device)
    kw: dict = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    host, _, port = coordinator.rpartition(":")
    wait = timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), size, is_master=rank == 0,
                          timeout=wait)
    dist.init_process_group(backend, store=store, world_size=size,
                            rank=rank, timeout=wait, **kw)
    return Group(rank, size, backend, dev, store, timeout)


class ProcessPlacement(_Placement):
    """This process's ``local`` placement over its own devices, joined
    with ``group``: the shard axis spans ``group.size * k`` global blocks
    (``k`` local ones), process ``p`` holding global blocks ``[p*k,
    (p+1)*k)``.  Host arrays placed on it are this process's rows only."""

    def __init__(self, local, group: Group):
        self._init_devices(local.devices)
        self.local, self.group = local, group
        self.axis = local.axis
        self.words_size = local.words_size
        self.n_devices = local.n_devices * group.size

    def layout(self, n_shards: int, n_words: int | None = None) -> tuple:
        """The local blocks' layout over this process's ``n_shards``
        rows."""
        return self.local.layout(n_shards, n_words)

    @property
    def key(self) -> tuple:
        return ("procs", self.group.size) + self.local.key

    def place_local(self, host_rows) -> Blocked:
        """This process's blocks from its own rows (axis 0 = its shards),
        as :meth:`place` builds them: the counterpart of
        ``jax.make_array_from_process_local_data``."""
        return self.place(host_rows)
