"""Named package loggers with per-package levels and a pluggable factory.

reference: logger/ (ILogger, GetLogger, SetLoggerFactory) [U].
"""
from __future__ import annotations

import logging
import sys
from typing import Callable, Dict, Optional

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG

_factory: Optional[Callable[[str], logging.Logger]] = None
_loggers: Dict[str, logging.Logger] = {}
_handler: Optional[logging.Handler] = None


def _default_handler() -> logging.Handler:
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stderr)
        _handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).1s | %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    return _handler


def set_logger_factory(factory: Callable[[str], logging.Logger]) -> None:
    """Install a custom logger factory (reference: logger.SetLoggerFactory [U])."""
    global _factory
    _factory = factory
    _loggers.clear()


def get_logger(pkg: str) -> logging.Logger:
    """Get the named package logger ("raft", "rsm", "transport", "logdb",
    "nodehost", ...)."""
    if pkg not in _loggers:
        if _factory is not None:
            _loggers[pkg] = _factory(pkg)
        else:
            lg = logging.getLogger(f"dragonboat_tpu.{pkg}")
            if not lg.handlers:
                lg.addHandler(_default_handler())
                lg.propagate = False
            lg.setLevel(logging.WARNING)
            _loggers[pkg] = lg
    return _loggers[pkg]


def set_package_log_level(pkg: str, level: int) -> None:
    get_logger(pkg).setLevel(level)
