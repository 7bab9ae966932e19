"""Tracing and profiling hooks.

Counterpart of pillarnext_tpu/utils/profiling.py:23-62:

- ``trace(logdir)`` records ``torch.profiler`` activity (host, and the
  card's kernels when the tensors are on one) over the block and writes
  it to ``logdir`` as a Chrome trace (``trace.json``, for chrome://tracing
  or Perfetto); the training CLI's ``--profile``.
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``).
- ``enable_nan_checks()``: autograd's anomaly mode, which raises where a
  backward first gives a NaN (the runtime analogue of the reference's
  hand-written NaN guards in RegLoss, centerloss.py:56-57).
- ``StepTimer``: wall-clock step times; ``tick`` fences with
  ``torch.cuda.synchronize()`` when a card is in use, since kernel
  launches return before the kernels end.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str):
    """Named range: ``with annotate('backbone'): ...`` inside traced code."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Rolling step timer: call ``tick()`` once a step, after it is
    issued; ``device`` (a torch device or name) picks the fence, a CUDA
    device synchronising before the clock is read."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []
        self._last = None

    def tick(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt:
            self.times.append(dt)
            self.times = self.times[-self.window:]
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0
