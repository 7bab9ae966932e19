"""Tracing for the training CLI's ``--profile``.

Counterpart of pillarnext_tpu/utils/profiling.py:23-29, which wraps
``jax.profiler`` tracing: here ``trace(logdir)`` records ``torch.profiler``
activity (host, and the card's kernels when the tensors are on one) over
the block and writes it to ``logdir`` as a Chrome trace
(``trace.json``, for chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

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
