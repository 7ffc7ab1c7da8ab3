"""Structured logging (the port's copy of gpis_tpu/utils/logging.py): stdlib
logging under the `gpis_tpu_torch` logger, with optional JSON-lines output
for machine consumption."""

from __future__ import annotations

import json
import logging
import sys
import time

__all__ = ["get_logger", "enable_json_logs"]

_LOGGER_NAME = "gpis_tpu_torch"


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def get_logger(name: str | None = None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME if name is None else f"{_LOGGER_NAME}.{name}")
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return logger


def enable_json_logs(stream=None) -> None:
    root = logging.getLogger(_LOGGER_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(_JsonFormatter())
    root.addHandler(h)
    root.setLevel(logging.INFO)
