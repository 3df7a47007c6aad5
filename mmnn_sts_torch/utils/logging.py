"""Stdout logger + per-epoch JSONL metrics (counterpart of the JAX
package's utils/logging.py: ``get_logger`` and ``MetricsWriter``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class _StdoutHandler(logging.StreamHandler):
    """Resolves sys.stdout at emit time (plays well with capture/redirect)."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):  # base-class ctor assigns; ignore
        pass


def get_logger(name: str = "mmnn_sts_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


class MetricsWriter:
    """Appends one JSON object per ``write`` to ``path`` (metrics.jsonl),
    with a ``ts`` timestamp, as the JAX package writes its rows."""

    def __init__(self, path: str = "metrics.jsonl"):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, **record):
        record.setdefault("ts", time.time())
        self._f.write(json.dumps(record, default=float) + "\n")

    def close(self):
        self._f.close()
