"""Process-wide forward-progress hook.

Long-running build stages (reduced-rank mirror builds, streamed oracle
passes) call :func:`mark` as they complete sub-steps. A harness that wants
to see forward progress registers a callback via :func:`set_hook`;
everything else pays one attribute load + None-check. Nothing registers
one since the benchmark's stall watchdog went; whether the marks stay is
ROADMAP Queue 3 #2.
"""
from __future__ import annotations

from typing import Callable, Optional

_hook: Optional[Callable[[], None]] = None


def set_hook(fn: Optional[Callable[[], None]]) -> None:
    global _hook
    _hook = fn


def mark() -> None:
    if _hook is not None:
        _hook()
