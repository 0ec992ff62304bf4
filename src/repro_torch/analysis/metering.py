"""Metering sites of the port (a copy of ``repro.analysis.metering``).

Some host syncs are the *point* of the code: one-time route calibration
timings, benchmark harness readbacks, admission-time cost probes.  The
``@metered`` decorator marks such a function as a sanctioned metering
site (``repro``'s lint rule RL003, host sync in a hot path, skips any
function whose decorator name contains ``metered``).

The decorator is intentionally almost-nothing at runtime: it tags the
function and counts calls, so tests (and future budget gates) can assert
that metering sites stay out of per-round loops — a metering site called
O(rounds) times is a bug even if each sync is cheap.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, TypeVar

__all__ = ["metered", "is_metered", "meter_count", "reset_meters"]

F = TypeVar("F", bound=Callable[..., Any])

_counts: dict = {}


def metered(fn: F) -> F:
    """Mark ``fn`` as a sanctioned host-sync metering site."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        key = f"{fn.__module__}.{fn.__qualname__}"
        _counts[key] = _counts.get(key, 0) + 1
        return fn(*args, **kwargs)

    wrapper.__repro_metered__ = True  # type: ignore[attr-defined]
    return wrapper  # type: ignore[return-value]


def is_metered(fn: Callable) -> bool:
    return bool(getattr(fn, "__repro_metered__", False))


def meter_count(fn: Callable) -> int:
    inner = getattr(fn, "__wrapped__", fn)
    key = f"{inner.__module__}.{inner.__qualname__}"
    return _counts.get(key, 0)


def reset_meters() -> None:
    _counts.clear()
