"""Logging for lightgbm_tpu_torch.

A copy of lightgbm_tpu/utils/log.py (the port imports nothing of the JAX
package): same levels and ``[LightGBM] [Level]`` stdout prefix as the
reference's static logger (include/LightGBM/utils/log.h:12-90).  ``fatal``
raises :class:`LightGBMError` (alias :data:`Fatal`) instead of calling
``exit(1)`` so library users get a catchable exception; the CLI converts it
to a non-zero exit.
"""
from __future__ import annotations

import sys

# Levels mirror log.h: Fatal=-1, Error=0, Warning=1, Info=2, Debug=3.
FATAL = -1
ERROR = 0
WARNING = 1
INFO = 2
DEBUG = 3

_level = INFO


class LightGBMError(RuntimeError):
    """Raised where the reference would Log::Fatal + exit(1)."""


Fatal = LightGBMError


def set_level(level: int) -> None:
    global _level
    _level = level


def set_level_from_verbosity(verbosity: int) -> None:
    """The reference's verbosity → level rule (config.cpp:59-70):
    1 → Info, 0 → Warning, >= 2 → Debug, < 0 → Fatal."""
    if verbosity == 1:
        set_level(INFO)
    elif verbosity == 0:
        set_level(WARNING)
    elif verbosity >= 2:
        set_level(DEBUG)
    else:
        set_level(FATAL)


def _write(tag: str, msg: str) -> None:
    sys.stdout.write(f"[LightGBM] [{tag}] {msg}\n")
    sys.stdout.flush()


def info(msg: str, *args) -> None:
    if _level >= INFO:
        _write("Info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    if _level >= WARNING:
        _write("Warning", msg % args if args else msg)


def error(msg: str, *args) -> None:
    if _level >= ERROR:
        _write("Error", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    """Equivalent of Log::Fatal (log.h:63-72) minus the process kill."""
    text = msg % args if args else msg
    _write("Fatal", text)
    raise LightGBMError(text)


def check(condition: bool, msg: str = "check failed") -> None:
    """CHECK macro equivalent (log.h:12-21)."""
    if not condition:
        fatal(msg)
