"""Process-wide registry of runtime events (the slice of
``repro.core.telemetry`` this port runs).

Components record one-off facts about how the process is running — which
kernel library was built, from which sources, and how long the build
took — so a caller can print them beside its results.  The tracer and
the metrics registry are not ported yet (ROADMAP queue 1, item 9)."""
from __future__ import annotations

import threading

__all__ = ["note_runtime_event", "runtime_events"]

_RUNTIME_EVENTS: dict[str, dict] = {}
_RUNTIME_LOCK = threading.Lock()


def note_runtime_event(key: str, message: str,
                       category: str = "runtime") -> None:
    """Record (or count again) the event ``key``; the first message
    sticks."""
    with _RUNTIME_LOCK:
        ev = _RUNTIME_EVENTS.setdefault(
            key, {"category": category, "message": message, "count": 0})
        ev["count"] += 1


def runtime_events() -> dict[str, dict]:
    """A snapshot of every recorded event, sorted by key."""
    with _RUNTIME_LOCK:
        return {k: dict(v) for k, v in sorted(_RUNTIME_EVENTS.items())}
