"""The plain reference against the program, and the check against faults,
on tiny stand-ins of every cell on the CPU (float32 on both sides, so the
program must agree with the reference within float32's rounding)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, common
from benchmark.control import FAULTS, half_batch
from benchmark.modes import eval as em
from benchmark.modes import train as tm
from benchmark.reference import model as ref
from benchmark.reference import postprocess
from benchmark.tests import tiny

TRAIN = ["pp18-train-b6", "voxel18-train-b6"]
EVAL = ["pp18-eval-b4", "voxel18-eval-b4"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_reference_follows_the_program(cell):
    r = tiny.run(cell)
    v = r.values
    assert v["loss_gap"] < 1e-3 and v["grad_gap"] < 1e-3 and v["update_gap"] < 0.1, v
    assert r.attempted > 0 and r.failed == 0
    assert check.correct(r.checks)


@pytest.mark.parametrize("cell", EVAL)
def test_eval_reference_follows_the_program(cell):
    r = tiny.run(cell)
    v = r.values
    assert v["missed"] == 0.0 and v["score_gap"] < 1e-4 and v["centre_gap"] < 1e-4, v
    assert sum(len(p["scores"]) for p, _ in r.frames) > 0
    assert check.correct(r.checks)


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(model, opt, batch):
        before = [p.detach().clone() for p in opt.params]
        out = step(model, opt, batch)
        with torch.no_grad():
            for p, b in zip(opt.params, before):
                p.copy_(b)
        return out
    return broken


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(cell, fault):
    r = tiny.run(cell, program=unchanged if fault == "unchanged" else half_batch)
    assert not check.correct(r.checks), r.checks


@pytest.mark.parametrize("cell", EVAL)
def test_an_altered_answer_is_not_correct(cell):
    """Each detection moved 1 m where the predict produces it."""
    r = tiny.run(cell, program=FAULTS["eval"]["moved"])
    assert not check.correct(r.checks), r.checks


@pytest.mark.parametrize("cell", EVAL)
def test_half_the_frames_left_out_is_not_correct(cell):
    """The predict answers the first half of each batch's frames only."""
    r = tiny.run(cell, program=FAULTS["eval"]["half_batch"])
    assert r.values["missed"] >= 0.4, r.values
    assert not check.correct(r.checks), r.checks


def test_a_frame_answered_with_nothing_counts_as_missed():
    ref = {"boxes": np.zeros((4, 9)), "scores": np.array([0.9, 0.8, 0.7, 0.6]), "labels": np.zeros(4)}
    ref["boxes"][:, 0] = [0.0, 5.0, 10.0, 15.0]
    empty = {"boxes": np.zeros((0, 9)), "scores": np.zeros(0), "labels": np.zeros(0)}
    v = check.eval_values([(ref, ref), (empty, ref)])
    assert v["missed"] == 0.5 and v["missed_top"] == 0.5 and v["centre_gap"] == 0.0


def test_the_traced_eval_stretch_reads_the_host_untraced():
    cell = "pp18-eval-b4"
    r = tiny.run(cell, trace=True)
    spec = tiny.spec(cell)
    k = spec.traffic["host_batches"]
    assert len(r.extra["after_neck_s"]) == k and r.extra["host_s"] > 0
    assert r.attempted == spec.traffic["batch"] * (k + spec.traffic["trace_batches"])
    assert spec.reader("head_host_ms.eval")(r) > 0
    # no device time on the CPU: the shares of the card read nothing
    assert spec.reader("eval_mfu")(r) is None and spec.reader("idle_pct.eval")(r) is None


@pytest.mark.parametrize("cell", TRAIN)
def test_the_float8_control_reads_above_the_program(cell):
    """The reference in float8 against float32 departs further than the
    float32 program does (the control's chip readings set the limits)."""
    from benchmark.control import control_values

    spec = tiny.spec(cell)
    low, _, _ = control_values(spec, 0, torch.device("cpu"), "float8")
    sound = tiny.run(cell).values
    assert max(low[k] / max(sound[k], 1e-12) for k in low) > 10, (low, sound)


def test_rotated_iou():
    """Unit squares: identical, shifted by half, rotated 45 degrees about
    the same centre (overlap 2 (sqrt 2 - 1)), disjoint."""
    a = torch.tensor([[0.0, 0.0, 1.0, 1.0, 0.0]] * 4)
    b = torch.tensor([[0.0, 0.0, 1.0, 1.0, 0.0], [0.5, 0.0, 1.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0, 1.0, np.pi / 4], [3.0, 0.0, 1.0, 1.0, 0.3]])
    inter = postprocess.intersection(a.double(), b.double())
    assert torch.allclose(inter, torch.tensor([1.0, 0.5, 2 * (2 ** 0.5 - 1), 0.0], dtype=torch.float64), atol=1e-9)
    keep = postprocess.nms(torch.cat([a[:1], b[1:]]), 0.2, 10)
    assert keep == [0, 3]  # IoU 1/3 and 0.71 with the first: suppressed
    assert postprocess.nms(torch.cat([a[:1], b[1:]]), 0.5, 10) == [0, 1, 3]


def test_precision_rounds_and_passes_the_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    for name, tol in (("bfloat16", 2 ** -8), ("float8", 2 ** -3)):
        q = ref.Precision(name)(x)
        assert (q - x).abs().max() <= tol * 3 + 1e-6
        (g,) = torch.autograd.grad(q.sum(), x)
        assert torch.equal(g, torch.ones_like(x))
    assert ref.Precision()(x) is x


def test_weights_are_made_from_the_seed():
    spec = tiny.spec("pp18-eval-b4")
    det = ref.Detector(spec.config["experiment"]["model"])
    a = common.make_weights(det, 5, "cpu", eval_stats=True)
    b = common.make_weights(det, 5, "cpu", eval_stats=True)
    c = common.make_weights(det, 6, "cpu", eval_stats=True)
    assert a.keys() == det.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["neck.weight"], c["neck.weight"])
    finals = [k for k in a if ".hm." in k and k.endswith(".bias")]
    assert sorted({round(float(a[k].max()), 5) for k in finals}) == [common.HM_BIAS, 0.0]
