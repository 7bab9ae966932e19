"""What the per-layer metric files share: each takes the traced stretch
of a run (``common.Run``) and returns a number, or None when it finds
nothing to read.  A share of a roofline or of a peak is never made up:
without device time it is None."""

from __future__ import annotations

from benchmark import counts
from benchmark.launches import DEVICE_NAMES


def per_item(r) -> int:
    return int(r.extra.get("steps") or r.extra.get("batches") or 0)


def mfu(r):
    """The reference model's FLOPs in the stretch over its seconds, as a
    share of the card's bf16 peak, in %."""
    if r.profile is None or not r.flops or r.profile.busy_s <= 0:
        return None
    return 100.0 * r.flops / r.profile.window_s / counts.PEAK_BF16_FLOPS


def host_mfu(r):
    """As ``mfu``, over the untraced stretch of an eval run (the profiler
    slows the host, and an eval batch is paced by the host)."""
    if r.profile is None or r.profile.busy_s <= 0 or not r.extra.get("host_s"):
        return None
    return 100.0 * r.extra["host_flops"] / r.extra["host_s"] / counts.PEAK_BF16_FLOPS


def host_idle(r):
    """The share of an untraced batch with nothing running on the card,
    in %: the traced stretch's busy seconds a batch over the untraced
    stretch's seconds a batch."""
    if r.profile is None or r.profile.busy_s <= 0 or not r.extra.get("host_s"):
        return None
    busy = r.profile.busy_s / r.extra["batches"]
    return 100.0 * (1.0 - busy / (r.extra["host_s"] / r.extra["host_batches"]))


def idle(r):
    """The share of the stretch with nothing running on the card, in %."""
    if r.profile is None or r.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.window_s)


def range_ms(r, name: str, device: bool):
    """Device (or host) ms a step or batch inside the ``bench.<name>`` ranges."""
    spans = r.profile.ranges(f"bench.{name}") if r.profile is not None else []
    n = per_item(r)
    if not spans or not n:
        return None
    total = sum(d if device else h for h, d in spans)
    if device and total <= 0:
        return None
    return total / 1e3 / n


def roofline(r, kind: str):
    """The least time of the kernel's launches (bytes and FLOPs these
    inputs need, ``counts.py``) over their device time, in %."""
    if r.profile is None or not r.launches:
        return None
    device_us = r.profile.kernel_us(*DEVICE_NAMES[kind])
    costs = r.launches.costs(kind)
    if device_us <= 0 or not costs:
        return None
    least = sum(counts.least_seconds(b, f) for b, f in costs)
    return 100.0 * least / (device_us / 1e6)
