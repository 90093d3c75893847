"""Tracing and step timing, the port of `sp_gan_tpu/utils/profiling.py`.

- `trace(log_dir)`: `torch.profiler` over the enclosed block (the CPU, and
  the GPU where there is one), written into `log_dir` as a Chrome trace
  (chrome://tracing, Perfetto);
- `annotate(name)`: a named range in that trace
  (`torch.profiler.record_function`);
- `StepTimer`: steps/s, points/s and ms/step over windows of steps.

The JAX package's `utils/cache.py` (XLA's persistent compile cache) has no
counterpart: the port compiles no XLA program, and its CUDA kernels are
cached as built libraries under `build/sp_gan_tpu_torch/`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profiles the enclosed block and writes its Chrome trace to
    `log_dir/trace_<pid>_<ns>.json`; yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str) -> record_function:
    """A named range that shows in `trace`'s timeline."""
    return record_function(name)


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
