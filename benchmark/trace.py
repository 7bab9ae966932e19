"""The traced stretch: torch.profiler over a few steps or batches of the
cell's own loop, and what the readers take from it.

``Profile`` holds the card's kernels, copies and fills (name, start, end
in microseconds), the benchmark's ``bench.*`` ranges (host start and end,
and the device time of the kernels launched inside them), and the host
ops, from which it works out the busy seconds (the union of the device
intervals), the device ops that took most time and the longest idle gaps,
each named by the innermost host range around it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Profile:
    def __init__(self, prof, window_s: float):
        dev, cpu = [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                    dev.append((e.name, *rng))  # a range's span on the card is no kernel
            else:
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                cpu.append((e.name, *rng, float(total)))
        self.device = sorted(dev, key=lambda r: r[1])
        self.host = cpu
        self.window_s = window_s
        self.busy_s = union_us([(s, e) for _, s, e in self.device]) / 1e6

    def kernel_us(self, *fragments: str) -> float:
        """Summed device time of the kernels whose name holds a fragment."""
        return sum(e - s for n, s, e in self.device if any(f in n for f in fragments))

    def ranges(self, name: str) -> list:
        """(host us, device us) of each host range called ``name``."""
        return [(e - s, d) for n, s, e, d in self.host if n == name]

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.device:
            by[n[:80]] = by.get(n[:80], 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device activity, each named by the
        shortest host op or range that spans its middle."""
        spans = merged([(s, e) for _, s, e in self.device])
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:])), reverse=True)[:top]
        if not self.host:
            return [["unknown", g / 1e6] for g, _, _ in gaps]
        names = np.array([h[0] for h in self.host], dtype=object)
        starts = np.array([h[1] for h in self.host], dtype=np.float64)
        ends = np.array([h[2] for h in self.host], dtype=np.float64)
        out = []
        for g, a, b in gaps:
            mid = (a + b) / 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "none" if not len(inside) else names[inside[np.argmin(ends[inside] - starts[inside])]]
            out.append([str(name)[:80], g / 1e6])
        return out


def merged(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals: list) -> float:
    return float(sum(e - s for s, e in merged(intervals)))


def profiled(step, n: int, device) -> Profile:
    """Run ``step(i)`` for i < n under torch.profiler (host and card), the
    stretch ending in a synchronise; its host seconds are the window."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.common import sync

    cuda = torch.device(device).type == "cuda"
    sync(device)
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        sync(device)
        window = time.perf_counter() - t0
    return Profile(prof, window)
