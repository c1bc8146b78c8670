"""Cooperative preemption: act at the next step boundary on SIGTERM.

Cloud fleets deliver an eviction notice (SIGTERM) shortly before a node is
reclaimed.  The handler only sets a flag; the serving loop
(`engine.frontdoor.FrontDoor`) polls `should_checkpoint()` between
dispatches, stops admitting and drains what it accepted.
"""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._handler)
                self._installed.append((sig, prev))
            except (ValueError, OSError):  # non-main thread / platform
                pass

    def _handler(self, signum, frame):  # noqa: ARG002
        self._flag.set()

    def request(self) -> None:
        """Programmatic preemption request (tests, watchdog EVICT)."""
        self._flag.set()

    def should_checkpoint(self) -> bool:
        return self._flag.is_set()

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed.clear()
