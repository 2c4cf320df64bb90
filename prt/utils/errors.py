"""Error reporting: Info/Warning/Error/Severe with context.

Analogue of the reference's 4-level reporter
(/root/reference/core/util.cpp:32-97): Info/Warning/Error continue,
Severe raises. The reference injects scene-file line numbers from lexer
globals (core/util.cpp:50-57); here the parser passes an explicit
``where`` string instead of global state.
"""
from __future__ import annotations

import sys

counts = {"info": 0, "warning": 0, "error": 0}


class SevereError(RuntimeError):
    """Raised by severe(); the reference aborts (core/util.cpp:92-97)."""


def _emit(level: str, msg: str, where: str | None = None):
    prefix = f"{level.capitalize()}"
    if where:
        prefix += f" ({where})"
    print(f"{prefix}: {msg}", file=sys.stderr)


def info(msg: str, where: str | None = None):
    counts["info"] += 1
    _emit("info", msg, where)


def warning(msg: str, where: str | None = None):
    counts["warning"] += 1
    _emit("warning", msg, where)


def error(msg: str, where: str | None = None):
    counts["error"] += 1
    _emit("error", msg, where)


def severe(msg: str, where: str | None = None):
    _emit("severe", msg, where)
    raise SevereError(msg)
