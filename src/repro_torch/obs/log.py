"""Copy of ``repro/obs/log.py`` for the PyTorch port: identical apart
from imports, so that the port records telemetry without importing the
JAX package.

Structured, rate-limited logging for the serving layer.

A long-lived server must be able to say "pinned readers are N epochs
behind head" without flooding stderr once per read.  This wraps the stdlib
``logging`` module (handlers/levels stay user-configurable the normal way)
with two additions: structured key=value rendering, and per-key rate
limiting so a condition that holds across thousands of requests emits one
line per interval.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict

__all__ = ["StructuredLogger", "get_logger"]


class StructuredLogger:
    """``log.warning("epoch lag", lag=7, epoch=42)`` →
    ``epoch lag lag=7 epoch=42`` through a stdlib logger.

    ``*_every`` variants emit at most once per ``interval_s`` per ``key``
    (monotonic clock) and return whether they emitted — callers can count
    suppressions."""

    def __init__(self, logger: logging.Logger):
        self._log = logger
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _fmt(msg: str, fields: dict) -> str:
        if not fields:
            return msg
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        return f"{msg} {kv}"

    def info(self, msg: str, **fields) -> None:
        self._log.info(self._fmt(msg, fields))

    def warning(self, msg: str, **fields) -> None:
        self._log.warning(self._fmt(msg, fields))

    def warning_every(self, interval_s: float, key: str, msg: str,
                      **fields) -> bool:
        """Rate-limited warning; returns True iff a line was emitted."""
        now = time.monotonic()
        with self._lock:
            last = self._last.get(key)
            if last is not None and now - last < interval_s:
                return False
            self._last[key] = now
        self.warning(msg, **fields)
        return True


def get_logger(name: str = "repro") -> StructuredLogger:
    return StructuredLogger(logging.getLogger(name))
