"""Meters for the training loop, the port of `sp_gan_tpu/utils/meters.py`
and of `StepTimer` (`sp_gan_tpu/utils/profiling.py`)."""

from __future__ import annotations

import time
from typing import Optional


class AverageValueMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Steps/s, points/s and ms/step over windows of `window` ticks, on the
    host clock (the caller synchronizes where it needs device time)."""

    def __init__(self, points_per_step: int, window: int = 50):
        self.pps = points_per_step
        self.window = window
        self._t0: Optional[float] = None
        self._count = 0

    def tick(self) -> Optional[dict]:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        if self._count % self.window:
            return None
        dt = now - self._t0
        self._t0, n = now, self._count
        self._count = 0
        return {"steps_per_sec": n / dt, "points_per_sec": n * self.pps / dt,
                "ms_per_step": 1000.0 * dt / n}
