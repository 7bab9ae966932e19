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

What the measurement tools (``tools/eval_breakdown.py``,
``train_breakdown.py``, ``baseline_probe.py``) and ``chip_smoke.py``
share: ``synced_ms`` (a call's host time, fenced on the card),
``median_ms``, ``device_profile`` (torch.profiler's device time of the
kernels one call launched, over the whole calls of a window cut by marker
kernels; card only), ``launches`` (each ported kernel's launches in a
call) and ``card`` (the name and power limit as ``nvidia-smi`` reads them).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
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


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def synced_ms(fn, device) -> tuple:
    """(``fn()``, its host time in ms, fenced by synchronisations on a CUDA
    device)."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def median_ms(fn, device, reps: int) -> tuple[float, list[float]]:
    """(median, times) of ``reps`` fenced calls of ``fn`` in ms."""
    times = [synced_ms(fn, device)[1] for _ in range(reps)]
    return statistics.median(times), times


PROFILE_WINDOWS = 8  # torch.profiler at times loses a whole window's records
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched between profiled calls


def split_calls(events: list) -> list:
    """A window's device records in start order, cut at the marker kernels
    launched between calls into one list per call; records before the
    first marker and after the last are dropped."""
    groups, cur = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if MARKER in e.name:
            if cur is not None:
                groups.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    return groups


def device_profile(fn, calls: int = 20, launches: int | None = None) -> dict:
    """Device time of one call of ``fn`` on the card under torch.profiler:
    the summed duration of every CUDA kernel, copy and fill that one call
    launched, averaged over the whole calls of a window of ``calls`` (after
    one warm-up call); the same split by kernel name; the device records
    of a whole call; and how many calls were whole.  Unlike ``median_ms``
    it leaves out the host time of the call and of its launches.  Only
    the card's activity is traced: most of a profile's processing is its
    host ops, which no figure here reads.

    torch.profiler at times loses device records (on the H100: one in most
    windows, or all of a window).  A marker kernel (``torch.cuda._sleep``)
    launched between calls cuts the window into calls, and a call counts
    only when it holds ``launches`` records (by default the count most
    calls hold): a lost record drops its call, never part of one.  A
    window with no whole call is profiled again, up to
    ``PROFILE_WINDOWS`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(1)
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        groups = split_calls([e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA])
        sizes = [len(g) for g in groups if g]
        want = launches if launches is not None else max(set(sizes), key=sizes.count, default=0)
        whole = [g for g in groups if g and len(g) == want]
        if whole:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no whole call in {PROFILE_WINDOWS} windows")
    by_name: dict = {}
    for e in (e for g in whole for e in g):
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time / 1e3 / len(whole)
    return {"device_ms": sum(by_name.values()), "device_ms_by_kernel": by_name,
            "device_launches_per_call": want, "device_whole_calls": len(whole), "device_calls": calls}


def device_ms(fn, device, calls: int) -> float | None:
    """``device_profile``'s device ms of one call on a CUDA ``device``;
    None on the CPU, where there is no device time (not measured)."""
    if torch.device(device).type != "cuda":
        return None
    return device_profile(fn, calls)["device_ms"]


def kernel_wrappers() -> tuple:
    """The three ported kernels' wrappers, whose ``launches`` count their
    launches (a CPU tensor takes the plain version and counts none)."""
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast

    return pfn_two_layer, monotone_row_gather, sorted_segment_bcast


def launches(fn) -> tuple:
    """(``fn()``, each ported kernel's launches in that call by name)."""
    wrappers = kernel_wrappers()
    before = [k.launches for k in wrappers]
    out = fn()
    return out, {k.__name__: k.launches - b for k, b in zip(wrappers, before)}


def card(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (the line of the
    device's index), or None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return lines[device.index or 0]
