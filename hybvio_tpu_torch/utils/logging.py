"""Logging facade (a copy of the reference package's ``utils/logging.py``;
reference: src/util/logging.hpp log_debug/info/warn/error macros): stdlib
logging with the same four levels and a verbosity switch like the reference
CLI's -v flag."""
from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("hybvio_tpu_torch")


def setup_logging(verbosity: int = 0) -> None:
    """verbosity: 0 = warnings, 1 = info, 2+ = debug (reference: main.cpp
    -v levels, :413-417)."""
    level = (logging.WARNING, logging.INFO, logging.DEBUG)[min(verbosity, 2)]
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(levelname).1s %(message)s"))
    _logger.handlers[:] = [handler]
    _logger.setLevel(level)


def log_debug(msg, *args):
    _logger.debug(msg, *args)


def log_info(msg, *args):
    _logger.info(msg, *args)


def log_warn(msg, *args):
    _logger.warning(msg, *args)


def log_error(msg, *args):
    _logger.error(msg, *args)
