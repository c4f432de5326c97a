"""Graceful stop on SIGTERM/SIGINT: port of ``rtts/train/interrupt.py``.

``GracefulStop`` turns the first SIGTERM or SIGINT into a flag that the
trainer polls at step boundaries: it then saves the completed step and
returns.  A second signal restores the previous handler and re-raises.
Outside the main thread no handler can be installed and the flag is never
set.  Single process only (the port trains on one device).
"""

from __future__ import annotations

import signal
import threading


class GracefulStop:
    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self._event = threading.Event()
        self._prev: dict = {}

    def __enter__(self) -> "GracefulStop":
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread: poll-only mode
            self._prev.clear()
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev.clear()
        return False

    def _handle(self, signum, frame) -> None:
        if self._event.is_set():
            prev = self._prev.get(signum)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self._event.set()

    @property
    def stop_requested(self) -> bool:
        return self._event.is_set()

    def request_stop(self) -> None:
        """Programmatic trigger, the same as the first signal."""
        self._event.set()
