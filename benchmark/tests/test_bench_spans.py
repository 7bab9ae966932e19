"""CPU tests of the readers of the program's own spans, on a synthetic
traced stretch: each metric's arithmetic a step or batch, the backward
read from the engine's events inside ``train.backward`` whatever their
thread, and None where the program opened no span or the card ran
nothing under it."""

from __future__ import annotations

import pytest

from benchmark.spec import Spec
from benchmark.trace import Profile

ENGINE = "autograd::engine::evaluate_function: "


class _Run:
    def __init__(self, host, **extra):
        self.profile = Profile.__new__(Profile)
        self.profile.host, self.profile.device = host, []
        self.profile.busy_s = self.profile.window_s = 1.0
        self.extra = extra


def read(metric: str, run):
    cell = "pp18-train-b6" if metric.endswith(".train") else "pp18-eval-b4"
    return Spec(cell).reader(metric)(run)


# two steps: (name, host start us, host end us, device us); the engine's
# events run on autograd's device thread, inside train.backward in time
# but not its children, so the range's own device time is a scalar fill
TRAIN = [
    ("train.step", 0, 1000, 900.0),
    ("train.forward", 10, 300, 400.0),
    ("train.backward", 300, 800, 2.0),
    (ENGINE + "ConvolutionBackward0", 310, 400, 500.0),
    (ENGINE + "torch::autograd::AccumulateGrad", 790, 800, 10.0),
    ("train.optimizer", 850, 990, 60.0),
    ("train.step", 1000, 2000, 900.0),
    ("train.forward", 1010, 1300, 440.0),
    ("train.backward", 1300, 1800, 2.0),
    (ENGINE + "ConvolutionBackward0", 1400, 1500, 700.0),
    ("train.optimizer", 1850, 1990, 80.0),
    # outside every train.backward: a backward before the stretch's step
    # and an engine event after the last one
    (ENGINE + "MulBackward0", 250, 260, 1e6),
    (ENGINE + "MulBackward0", 1810, 1820, 1e6),
]

# the same two steps with kernels handed to runtime calls and profiler
# markers by a clash of correlation ids: under the forward a
# cudaLaunchKernel holding a Command Buffer Full (its 30 us inside the
# call's 40), under an engine event a cudaStreamIsCapturing; the
# cudaMalloc outside every phase counts nowhere
CLASHED = TRAIN + [
    ("cudaLaunchKernel", 100, 120, 40.0),
    ("Command Buffer Full", 105, 110, 30.0),
    ("cudaStreamIsCapturing", 320, 330, 25.0),
    ("cudaMalloc", 820, 840, 1e6),
]
CLASHED = [(n, s, e, d + (40.0 if n == "train.forward" and s == 10 else 0.0)
            + (25.0 if n == ENGINE + "ConvolutionBackward0" and s == 310 else 0.0)) for n, s, e, d in CLASHED]

# two batches; the NMS's host reads and its device time inside the head's
EVAL = [
    ("model.backbone", 0, 40, 50.0),
    ("model.head", 40, 100, 30.0),
    ("nms", 60, 90, 12.0),
    *[("nms.sync", 60 + i, 61 + i, 0.5) for i in range(5)],
    ("model.backbone", 200, 240, 50.0),
    ("model.head", 240, 300, 34.0),
    ("nms", 260, 290, 14.0),
    *[("nms.sync", 260 + i, 261 + i, 0.5) for i in range(7)],
]


@pytest.mark.parametrize("metric, want", [
    ("forward_ms.train", (400 + 440) / 2 / 1e3),
    ("optimizer_ms.train", (60 + 80) / 2 / 1e3),
    ("backward_ms.train", (500 + 10 + 700) / 2 / 1e3),
])
def test_train_phases_a_step(metric, want):
    assert read(metric, _Run(TRAIN, steps=2)) == pytest.approx(want)


@pytest.mark.parametrize("metric, want", [
    ("forward_ms.train", (400 + 440) / 2 / 1e3),
    ("optimizer_ms.train", (60 + 80) / 2 / 1e3),
    ("backward_ms.train", (500 + 10 + 700) / 2 / 1e3),
])
def test_kernels_carried_by_runtime_calls_and_markers_are_left_out(metric, want):
    assert read(metric, _Run(CLASHED, steps=2)) == pytest.approx(want)


@pytest.mark.parametrize("metric, want", [
    ("head_ms.eval", (30 + 34) / 2 / 1e3),
    ("nms_ms.eval", (12 + 14) / 2 / 1e3),
    ("nms_syncs.eval", 6.0),
])
def test_eval_spans_a_batch(metric, want):
    assert read(metric, _Run(EVAL, batches=2)) == pytest.approx(want)


def test_backward_counts_engine_events_inside_its_range_alone():
    """The engine's events outside every ``train.backward`` range (here a
    million us each) are left out, and the range's own device time, which
    the main thread launched, is not the backward."""
    got = read("backward_ms.train", _Run(TRAIN, steps=2))
    assert got < 1.0
    only_outside = [h for h in TRAIN if h[0] in ("train.backward", ENGINE + "MulBackward0")]
    assert read("backward_ms.train", _Run(only_outside, steps=2)) is None


@pytest.mark.parametrize("metric", ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                                    "head_ms.eval", "nms_ms.eval", "nms_syncs.eval"])
def test_none_without_a_span_or_device_time(metric):
    """A program without the spans (the parent's), a stretch without a
    profile, and spans under which the card ran nothing."""
    per = {"steps": 2} if metric.endswith(".train") else {"batches": 2}
    others = [h for h in TRAIN + EVAL if h[0].startswith(("bench.", "aten::"))] + [("bench.backbone", 0, 9, 5.0)]
    assert read(metric, _Run(others, **per)) is None
    empty = _Run([], **per)
    empty.profile = None
    assert read(metric, empty) is None
    if metric != "nms_syncs.eval":
        idle = [(n, s, e, 0.0) for n, s, e, _ in TRAIN + EVAL]
        assert read(metric, _Run(idle, **per)) is None


def test_nms_within_the_head():
    r = _Run(EVAL, batches=2)
    assert read("nms_ms.eval", r) <= read("head_ms.eval", r)


@pytest.mark.parametrize("cell", ["pp18-train-b6", "pp18-eval-b4"])
def test_the_programs_spans_reach_the_traced_stretch(cell):
    """A tiny traced run on the CPU: the program's spans are among the
    stretch's host events, once a step or a batch, and the sync count
    reads; the CPU has no device time, so the ms read None."""
    from benchmark.spans import span_count
    from benchmark.tests import tiny

    r = tiny.run(cell, trace=True)
    if cell.endswith("train-b6"):
        for name in ("train.step", "train.forward", "train.backward", "train.optimizer"):
            assert span_count(r, name) == 1.0, name
        assert read("forward_ms.train", r) is None and read("backward_ms.train", r) is None
    else:
        assert span_count(r, "model.head") == span_count(r, "model.backbone") == 1.0
        assert read("nms_syncs.eval", r) >= 2.0  # a chunk's read and a fixpoint round's, at least
        assert read("head_ms.eval", r) is None
