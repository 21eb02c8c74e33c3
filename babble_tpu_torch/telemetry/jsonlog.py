"""Structured JSON logging (`--log_format json`).

One JSON object per line with fixed fields (ts, level, logger, msg,
node) plus whitelisted structured extras (span_id, peer, round, ...),
so the logs of a multi-node harness merge into one machine-sortable
stream: `cat node*.log | jq -s 'sort_by(.ts)'`. Schema in
docs/observability.md."""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

# Structured extras lifted off LogRecord.__dict__ when present
# (populated via `logger.info(..., extra={...})`).
_EXTRA_FIELDS = ("span_id", "peer", "round", "event", "block", "phase")


class JsonLogFormatter(logging.Formatter):
    """Formats every record as one JSON line. `node_id` is stamped
    into each record; it is mutable because the CLI configures logging
    before the node id is known (the key must be loaded first) and
    backfills it."""

    def __init__(self, node_id: Optional[int] = None):
        super().__init__()
        self.node_id = node_id

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if self.node_id is not None:
            obj["node"] = self.node_id
        for key in _EXTRA_FIELDS:
            if key in record.__dict__:
                obj[key] = record.__dict__[key]
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, default=str)


def use_json_logging(logger: Optional[logging.Logger] = None,
                     node_id: Optional[int] = None) -> JsonLogFormatter:
    """Swap every handler of `logger` (default: root) to the JSON
    formatter; returns the formatter so the caller can backfill
    `node_id` once known."""
    fmt = JsonLogFormatter(node_id)
    target = logger if logger is not None else logging.getLogger()
    for handler in target.handlers:
        handler.setFormatter(fmt)
    return fmt
