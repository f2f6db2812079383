"""The executor's error classes (``pilosa_tpu.exec.executor``'s), apart so
the batcher raises them without importing the executor."""

from __future__ import annotations


class ExecutionError(Exception):
    pass


class QueryTimeoutError(ExecutionError):
    """The query's deadline passed.  Checked between calls, between
    streamed blocks and while blocked on the batcher; ``stage`` names
    where a batcher item was when the clock ran out (``queued``,
    ``dispatch`` or ``readback``) and is None at a call boundary.  The
    REST edge answers it as a 504 with a ``timeout`` block."""

    def __init__(self, msg: str, stage: str | None = None):
        super().__init__(msg)
        self.stage = stage


class PipelineStalledError(ExecutionError):
    """A batcher window outlived the watchdog bound in ``stage`` and was
    quarantined: its callers fail loudly instead of waiting on a sick
    card.  The REST edge answers it as a 500 with a ``pipelineStall``
    block."""

    def __init__(self, msg: str, stage: str = "dispatch",
                 elapsed: float = 0.0):
        super().__init__(msg)
        self.stage = stage
        self.elapsed = elapsed


class WriteUnavailableError(ExecutionError):
    """A cluster write cannot serve now: a replica is down and hinted
    handoff cannot cover it.  ``reason`` is ``replica_down`` (handoff
    off), ``hint_overflow`` (the peer's backlog outlived
    ``hint_max_age``), ``no_live_replica`` or ``replica_busy`` (an alive
    replica shed the op).  The REST edge answers it as a 503 with
    ``Retry-After`` and a ``writeUnavailable{op, replica, reason}``
    block."""

    def __init__(self, msg: str, op: str, replica: str | None,
                 reason: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.op = op
        self.replica = replica
        self.reason = reason
        self.retry_after = retry_after


class MeshNotSupported(ExecutionError):
    """A torch operation on a blocked tensor (``pilosa_tpu_torch.parallel.
    mesh``) that no serving path routes: every call answers under a
    placement, and an operation that would gather a resident plane onto
    one device, or read partial counts as whole, is refused rather than
    answered another way.  The REST edge answers it as a 400."""
