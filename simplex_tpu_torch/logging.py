"""Structured logging with levels: ``simplex_tpu.logging`` for the port.

Stdlib logging under the ``simplex_tpu_torch`` logger, configured once
from the environment:

  SIMPLEX_TPU_LOG       level name (DEBUG/INFO/WARNING/ERROR; default WARNING)
  SIMPLEX_TPU_LOG_JSON  "1" -> one JSON object per line (machine-parseable)

Usage: ``log = get_logger("twophase"); log.info("phase 1 complete",
extra=fields(iters=i))``. Structured fields ride the ``extra`` dict and
appear as JSON keys (or a ``key=value`` suffix in text mode).
"""

from __future__ import annotations

import json
import logging
import os
import time

ROOT = "simplex_tpu_torch"
_CONFIGURED = False
_FIELDS_KEY = "simplex_fields"


def fields(**kw):
    """Structured fields for a log call: ``log.info("msg", extra=fields(x=1))``."""
    return {_FIELDS_KEY: kw}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        obj.update(getattr(record, _FIELDS_KEY, None) or {})
        return json.dumps(obj)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        extra = getattr(record, _FIELDS_KEY, None)
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        return base


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True
    root = logging.getLogger(ROOT)
    level = os.environ.get("SIMPLEX_TPU_LOG", "WARNING").upper()
    root.setLevel(getattr(logging, level, logging.WARNING))
    handler = logging.StreamHandler()
    if os.environ.get("SIMPLEX_TPU_LOG_JSON"):
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            _TextFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``simplex_tpu_torch.<name>`` (``name`` as given when it
    already starts with the package name)."""
    _configure()
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def set_level(level: str) -> None:
    """Programmatic override (the CLI's --log-level flag)."""
    _configure()
    logging.getLogger(ROOT).setLevel(getattr(logging, level.upper(), logging.WARNING))
