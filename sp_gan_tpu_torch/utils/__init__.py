"""Meters, step timing, tracing and the hang watchdog of the training
loop."""

from sp_gan_tpu_torch.utils.meters import AverageValueMeter
from sp_gan_tpu_torch.utils.profiling import StepTimer, annotate, trace
from sp_gan_tpu_torch.utils.watchdog import EXIT_CODE, Watchdog

__all__ = ["AverageValueMeter", "EXIT_CODE", "StepTimer", "Watchdog",
           "annotate", "trace"]
