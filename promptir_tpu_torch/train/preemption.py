"""Preemption-safe training: catch SIGTERM/SIGINT, checkpoint, exit clean.

A pure-Python copy of promptir_tpu/train/preemption.py. The reference has
no preemption story: recovery is a manual resume from the last epoch's
checkpoint (train.py:334,341). Here a guard flips a flag on SIGTERM or
SIGINT, the epoch loop notices at the next step boundary, saves a
checkpoint tagged so that `resume()` replays the interrupted epoch, and
returns instead of dying mid-write.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    """Latches termination signals into a flag the training loop polls.

    Signal handlers only install from the main thread; elsewhere (or when
    `signals=()`), the guard still works via `request()` — the cooperative
    shutdown path used by embedding applications and tests.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._event = threading.Event()
        self._prev: dict = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not in the main thread
                break

    def _on_signal(self, signum, frame):
        self._event.set()

    def request(self) -> None:
        """Programmatic preemption (cooperative shutdown)."""
        self._event.set()

    def preempted(self) -> bool:
        return self._event.is_set()

    def restore(self) -> None:
        """Reinstall the previous signal handlers (idempotent)."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.restore()
        return None
