"""Rank-prefixed logging: every line reads ``[accl r3] W message`` (or
``[accl]`` with no rank bound).  Level from ``ACCL_LOG``
(debug/info/warning/error, default warning); ``ACCL_DEBUG=1`` is an alias
for ``ACCL_LOG=debug``."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_ROOT = "accl_tpu_torch"
_configured = False


def level_from_env() -> int:
    raw = os.environ.get("ACCL_LOG", "").strip().lower()
    if raw:
        return _LEVELS.get(raw, logging.WARNING)
    return logging.DEBUG if os.environ.get("ACCL_DEBUG") else logging.WARNING


class _RankFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        rank = None
        if ".rank" in record.name:
            tail = record.name.rsplit(".rank", 1)[1]
            if tail.isdigit():
                rank = tail
        prefix = f"[accl r{rank}]" if rank is not None else "[accl]"
        return f"{prefix} {record.levelname[0]} {record.getMessage()}"


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_RankFormatter())
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(level_from_env())
    _configured = True


def get_logger(name: str = _ROOT, rank: Optional[int] = None) -> logging.Logger:
    _configure()
    return logging.getLogger(name if rank is None else f"{name}.rank{rank}")
