"""Logging: the port's logger (``pilosa_tpu.obs.logging``'s).

One ``get_logger`` with a verbosity switch and two formats: ``text``
(one key=value line per record) and ``json`` (``log_format = "json"``):
one JSON object per line with the ACTIVE trace id (the id of the request
the emitting thread is serving, :func:`pilosa_tpu_torch.obs.tracing.
current_trace_id`) as ``traceId``, so a slow query's exemplar, its
retained trace and its log lines join on one id.
"""

from __future__ import annotations

import json
import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per log line: timestamp, level, logger, message,
    and the emitting thread's active trace id (omitted when no request
    is being served).  A record-level ``traceId`` (passed via
    ``extra=``) wins over the thread-local — emitters that outlive the
    request window (the slow-query capture logs after the serving
    ``finally`` reset) attach the id explicitly."""

    def format(self, record: logging.LogRecord) -> str:
        from pilosa_tpu_torch.obs.tracing import current_trace_id
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = getattr(record, "traceId", None) or current_trace_id()
        if trace_id:
            out["traceId"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def get_logger(name: str = "pilosa_tpu_torch", verbose: bool = False,
               stream=None, fmt: str | None = None) -> logging.Logger:
    """``fmt``: ``"json"`` installs the structured formatter,
    ``"text"`` the key=value default; ``None`` keeps whatever an
    earlier call configured (text on first creation)."""
    logger = logging.getLogger(name)
    created = False
    if not logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        logger.addHandler(h)
        logger.propagate = False
        created = True
    if fmt not in (None, "", "text", "json"):
        raise ValueError(f"unknown log_format {fmt!r} "
                         "(expected 'text' or 'json')")
    if fmt == "json":
        formatter: logging.Formatter = JsonFormatter()
    elif fmt == "text" or created:
        formatter = logging.Formatter(_FORMAT)
    else:
        formatter = None
    if formatter is not None:
        for h in logger.handlers:
            h.setFormatter(formatter)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger
