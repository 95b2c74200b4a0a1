"""Logging and the stall watchdog (counterparts of ``lstm_unet_tpu/utils``)."""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

# distinct from Python's 1 (exception), timeout(1)'s 124 and 128+N (signal),
# so a supervisor can key a relaunch on "stalled"
STALL_EXIT_CODE = 17


def log_print(*args, file=None, flush: bool = True) -> None:
    """Print with a wall-clock timestamp prefix."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    print(f"[{stamp}]", *args, file=file or sys.stdout, flush=flush)


class StallWatchdog:
    """Hard-exits the process with :data:`STALL_EXIT_CODE` when ``feed()`` is
    not called for ``timeout_s`` (``first_timeout_s`` before the first feed,
    which covers the kernel build and first-frame set-up). ``os._exit`` is
    the only exit that works when a thread is stuck in a native wait;
    ``on_stall`` replaces it in tests."""

    def __init__(self, timeout_s: float, label: str = "infer",
                 on_stall: Optional[Callable[[float], None]] = None,
                 first_timeout_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.first_timeout_s = float(first_timeout_s or timeout_s)
        self.label = label
        self._on_stall = on_stall or self._default_on_stall
        self._last = time.monotonic()
        self._fed_once = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_on_stall(self, stalled_for: float) -> None:
        log_print(f"WATCHDOG: no {self.label} progress for {stalled_for:.0f}s "
                  f"(timeout {self.timeout_s:.0f}s); exiting {STALL_EXIT_CODE}")
        os._exit(STALL_EXIT_CODE)

    def start(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"stall-watchdog-{self.label}", daemon=True)
        self._thread.start()
        return self

    def feed(self) -> None:
        self._last = time.monotonic()
        self._fed_once = True

    def stop(self) -> None:
        self._stop_evt.set()

    def _run(self) -> None:
        poll = min(self.timeout_s / 4.0, 10.0)
        while not self._stop_evt.wait(poll):
            stalled_for = time.monotonic() - self._last
            limit = self.timeout_s if self._fed_once else self.first_timeout_s
            if stalled_for > limit:
                self._on_stall(stalled_for)
                return
