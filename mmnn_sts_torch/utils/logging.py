"""Stdout logger (counterpart of the JAX package's utils/logging.py:get_logger)."""

from __future__ import annotations

import logging
import sys


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
