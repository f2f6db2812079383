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
