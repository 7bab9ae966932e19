"""What the readers of the program's own spans share.

The port opens ``torch.profiler.record_function`` ranges at its layer
boundaries (``pillarnext_tpu_torch/utils/profiling.annotate``): they land
in the traced stretch's host events (``trace.Profile.host``) beside the
kernels, with the device time of what each launched.  A program without
such a span (or a stretch with no device time under it) reads None.

torch.profiler hands a kernel to every host event whose id is the
kernel's correlation id, and the CUDA runtime's calls and the
profiler's own markers are numbered apart from the ops they sit in: on
an H100 (torch 2.11) a ``cudaStreamIsCapturing`` or a ``Command Buffer
Full`` under ``train.forward`` at times carried another op's kernels,
up to 10 ms a step.  Every kernel also stays with the op that launched
it, so the readers leave out what such events carry.
"""

from __future__ import annotations

import bisect

from benchmark.readers import per_item

# autograd's host event around each backward node, on whichever thread ran it
ENGINE = "autograd::engine::evaluate_function: "
MARKERS = ("Activity Buffer Request", "Command Buffer Full", "Buffer Flush")


def _not_an_op(name: str) -> bool:
    """A call into CUDA's own API (``cuda*``, ``cu*``) or one of the profiler's markers."""
    return name in MARKERS or (name.startswith("cu") and "::" not in name)


def _clashed_us(host: list, windows: list) -> float:
    """Device us carried by runtime calls and markers whose start lies in
    one of ``windows`` (sorted (start, end)), each counted once: one
    nested in another is inside the other's total."""
    total, last_end = 0.0, float("-inf")
    starts = [a for a, _ in windows]
    carriers = sorted((h for h in host if h[3] > 0 and _not_an_op(h[0])), key=lambda h: (h[1], -h[2]))
    for _, s, e, d in carriers:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s > windows[i][1] or e <= last_end:
            continue
        total += d
        last_end = e
    return total


def span_ms(r, name: str):
    """Device ms a step or batch of the kernels launched under the
    program's ``name`` spans."""
    if r.profile is None:
        return None
    spans = sorted((s, e, d) for n, s, e, d in r.profile.host if n == name)
    n = per_item(r)
    total = sum(d for _, _, d in spans) - _clashed_us(r.profile.host, [(s, e) for s, e, _ in spans])
    if not spans or not n or total <= 0:
        return None
    return total / 1e3 / n


def span_count(r, name: str):
    """The program's ``name`` spans a step or batch."""
    spans = r.profile.ranges(name) if r.profile is not None else []
    n = per_item(r)
    if not spans or not n:
        return None
    return len(spans) / n


def backward_ms(r):
    """Device ms a step of the backward: autograd runs a CUDA backward on
    its own device thread, so the main thread's ``train.backward`` range
    holds almost none of its device time.  Each engine event
    (``ENGINE``) whose host start lies inside a ``train.backward`` range
    counts, whatever its thread (all share the profiler's clock); a
    recompute is non-reentrant, so these events do not nest."""
    if r.profile is None:
        return None
    windows = sorted((s, e) for name, s, e, _ in r.profile.host if name == "train.backward")
    n = per_item(r)
    if not windows or not n:
        return None
    starts = [s for s, _ in windows]
    engine = []
    for name, s, e, d in r.profile.host:
        if name.startswith(ENGINE):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= windows[i][1]:
                engine.append((s, e, d))
    engine.sort()
    total = sum(d for _, _, d in engine) - _clashed_us(r.profile.host, [(s, e) for s, e, _ in engine])
    return total / 1e3 / n if total > 0 else None
