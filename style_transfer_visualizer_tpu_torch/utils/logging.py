"""Centralized logging for the port.

One shared logger instance, configured once; handler attach is idempotent
and propagation is disabled so the CLI controls its own output format.
"""
from __future__ import annotations

import logging

_DEFAULT_FORMAT = "%(asctime)s [%(levelname)s] %(message)s"


def setup_logger(
    name: str = __name__,
    level: int = logging.INFO,
    formatter: logging.Formatter | None = None,
    handler: logging.Handler | None = None,
) -> logging.Logger:
    """Return a logger with a single stream handler attached.

    Repeated calls with the same name do not stack handlers.
    """
    log = logging.getLogger(name)
    log.setLevel(level)
    if not log.handlers:
        handler = handler or logging.StreamHandler()
        handler.setFormatter(formatter or logging.Formatter(_DEFAULT_FORMAT))
        log.addHandler(handler)
        log.propagate = False
    return log


# Shared across every module in the package.
logger = setup_logger("style_transfer_torch")
