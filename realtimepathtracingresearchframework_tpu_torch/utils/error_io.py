"""Leveled colored console logging and error funnel.

TPU-native equivalent of ``util/error_io.{h,cpp}``: ``println(CLL::...)``,
``warning(...)``, ``throw_error(...)``.
"""

from __future__ import annotations

import os
import sys
import enum


class CLL(enum.IntEnum):
    """Console log level (reference: util/error_io.h)."""

    VERBOSE = 0
    INFORMATION = 1
    WARNING = 2
    CRITICAL = 3


_COLORS = {
    CLL.VERBOSE: "\033[90m",
    CLL.INFORMATION: "",
    CLL.WARNING: "\033[93m",
    CLL.CRITICAL: "\033[91m",
}
_RESET = "\033[0m"

_min_level = CLL.VERBOSE if os.environ.get("RPTR_VERBOSE") else CLL.INFORMATION


def set_min_level(level: CLL) -> None:
    global _min_level
    _min_level = level


def println(level: CLL, msg: str, *args) -> None:
    if level < _min_level:
        return
    text = msg % args if args else msg
    stream = sys.stderr if level >= CLL.WARNING else sys.stdout
    color = _COLORS.get(level, "") if stream.isatty() else ""
    reset = _RESET if color else ""
    print(f"{color}{text}{reset}", file=stream)


def verbose(msg: str, *args) -> None:
    println(CLL.VERBOSE, msg, *args)


def info(msg: str, *args) -> None:
    println(CLL.INFORMATION, msg, *args)


def warning(msg: str, *args) -> None:
    println(CLL.WARNING, msg, *args)


class RenderError(RuntimeError):
    """Raised by throw_error; equivalent of the reference's logged_exception
    funnel (main.cpp:208-257)."""


def throw_error(msg: str, *args) -> None:
    text = msg % args if args else msg
    println(CLL.CRITICAL, text)
    raise RenderError(text)
