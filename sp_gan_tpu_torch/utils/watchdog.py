"""Hang watchdog for long training runs, the port of
`sp_gan_tpu/utils/watchdog.py`.

A crash exits and a supervisor restarts the run with `--restore`. A wedged
device call does not: the process blocks in the CUDA runtime, never dies,
and a campaign stops making progress without a word. `Watchdog` turns that
into the crash the restore path handles: a daemon thread checks a
heartbeat that the training loop beats after every step; when the
heartbeat is older than the timeout it runs the timeout action, by default
a message and `os._exit(EXIT_CODE)` (a hung device call cannot be
recovered in the process, and the exit must not wait on Python
finalizers, which may block on it too).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

# a code of its own, so that a supervisor can tell "hung, restart me" from
# a crash
EXIT_CODE = 42


class Watchdog:
    """Calls `on_timeout(stale_seconds)` once when `beat()` has not been
    called for `timeout_s`.

    The clock runs between `start()` and `stop()`; `stop()` may be called
    from the watched thread right before a clean exit. The checker is a
    daemon thread, so it never blocks the interpreter's shutdown.
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[float], None]] = None,
                 poll_s: float = 5.0):
        self.timeout_s = float(timeout_s)
        self.poll_s = min(poll_s, max(0.05, self.timeout_s / 4))
        self._on_timeout = on_timeout or self._default_timeout
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the watched side ------------------------------------------------
    def beat(self):
        self._beat = time.monotonic()

    def start(self):
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="spgan-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    # -- internals ---------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_s):
            stale = time.monotonic() - self._beat
            if stale > self.timeout_s:
                self._fired.set()
                self._on_timeout(stale)
                return

    @staticmethod
    def _default_timeout(stale: float):
        print(f"[watchdog] no training progress for {stale:.0f}s — device "
              f"call presumed wedged; exiting {EXIT_CODE} for supervised "
              "restart (--restore)", flush=True)
        os._exit(EXIT_CODE)
