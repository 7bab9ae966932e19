"""The port's own spans (``utils/profiling.annotate``) on the CPU: a train
step and two served batches of the narrowed flagship under
``profiling.trace``, each span in its parent, a step's micro-batches,
the NMS's host reads counted against its ``nms.sync`` spans, nothing
opened without a profiler, and the same bits with and without one."""

from __future__ import annotations

import collections
import contextlib
import types
from pathlib import Path

import pytest
import torch

from pillarnext_tpu_torch.core import nms
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.train import trainer
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.utils import profiling
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment

FLAGSHIP = Path(__file__).resolve().parent.parent / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
NARROW = [f"model.reader.pc_range={PC}", "model.reader.voxel_size=[0.25,0.25,8.0]",
          "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
          "+model.reader.train_pillar_capacity=4096",
          "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
          "+model.backbone.out_channels=32", "model.neck.in_channels=32",
          "model.head.in_channels=32", "+model.head.share_conv_channel=32"]
SMALL_BUCKET = 256  # below the scene's occupied pillars: the first batch is repaired

# each span and the program span it opens in (the innermost one around
# it); a served predict opens the model's stages at the root
PARENTS = {
    "train.step": {None},
    "train.forward": {"train.step"},
    "train.backward": {"train.step"},
    "train.allreduce": {"train.step"},
    "train.optimizer": {"train.step"},
    "model.reader": {"train.forward", None},
    "model.backbone": {"train.forward", None},
    "model.neck": {"train.forward", None},
    "model.head": {"train.forward", None},
    "nms": {"model.head"},
    "nms.sync": {"nms"},
}


class _Recorded(torch.profiler.record_function):
    """``record_function`` that also keeps the name of each range it opens."""

    opened: list = []

    def __init__(self, name, args=None):
        super().__init__(name, args)
        _Recorded.opened.append(name)


def _span(e) -> str | None:
    """The innermost program span around host event ``e`` (its own thread)."""
    p = e.cpu_parent
    while p is not None and p.name not in PARENTS:
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same train step, two served batches (the first repaired) and
    two loader waits from the same state, once without a profiler and
    once under ``profiling.trace``, ``record_function`` made to keep the
    name of each range it opens; the NMS's host reads counted in the
    traced predicts."""
    torch.manual_seed(0)
    cfg = load_experiment(str(FLAGSHIP), NARROW)

    def make(train):
        return build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=train)

    batch = trainer.batch_to_device(synthetic_batches(cfg, 1, 1, 2000, seed=0, n_objects=3, max_points=3000)[0],
                                    "cpu")
    eval_model = make(False)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for traced in (False, True):
            model = make(True)
            opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
            predictor = AdaptivePredictor(eval_model, buckets=(SMALL_BUCKET, int(eval_model.reader.capacity)))
            _Recorded.opened = []
            mp.setattr(torch.profiler, "record_function", _Recorded)
            reads = collections.Counter()
            if traced:
                _count_nms_reads(mp, reads)
            with (profiling.trace(tmp_path_factory.mktemp("trace")) if traced else contextlib.nullcontext()) as prof:
                scalars, _ = train_step(model, opt, batch)
                dets = [predictor.predict(batch["points"], batch["points_mask"]) for _ in range(2)]
                waits = []
                items = list(trainer._timed([1, 2], waits))
            mp.undo()
            out[traced] = {"prof": prof, "opened": list(_Recorded.opened),
                           "scalars": scalars, "params": [p.detach().clone() for p in model.parameters()],
                           "dets": dets, "repaired": predictor.repaired, "reads": reads["reads"],
                           "items": items}
    finally:
        mp.undo()
    return out


def _count_nms_reads(mp, reads):
    """Count every ``torch.equal`` and ``Tensor.__bool__`` made inside
    ``nms._chunked_greedy``: the NMS loop's host reads."""
    inside = [False]
    greedy, equal, to_bool = nms._chunked_greedy, torch.equal, torch.Tensor.__bool__

    def counted_greedy(*a, **k):
        inside[0] = True
        try:
            return greedy(*a, **k)
        finally:
            inside[0] = False

    def counted_equal(*a, **k):
        reads["reads"] += inside[0]
        return equal(*a, **k)

    def counted_bool(self):
        reads["reads"] += inside[0]
        return to_bool(self)

    mp.setattr(nms, "_chunked_greedy", counted_greedy)
    mp.setattr(torch, "equal", counted_equal)
    mp.setattr(torch.Tensor, "__bool__", counted_bool)


def _events(runs):
    return [e for e in runs[True]["prof"].events() if e.name in PARENTS or e.name == "train.loader_wait"]


def test_every_span_appears_in_its_parent(runs):
    assert runs[True]["repaired"] == 1  # the first batch overflowed the small bucket
    events = _events(runs)
    seen = collections.Counter(e.name for e in events)
    assert set(PARENTS) <= set(seen), set(PARENTS) - set(seen)
    for e in events:
        if e.name in PARENTS:
            assert _span(e) in PARENTS[e.name], (e.name, _span(e))
    # one step, each phase once; the model's stages once in training, once
    # for each served batch and once for the repair
    for name in ("train.step", "train.forward", "train.backward", "train.allreduce", "train.optimizer"):
        assert seen[name] == 1, name
    for name in ("model.reader", "model.backbone", "model.neck", "model.head"):
        assert seen[name] == 4, name
    assert seen["nms"] >= 3  # each predict's head runs at least one NMS
    # the loader's waits: one for each item and one for its end
    assert seen["train.loader_wait"] == len(runs[True]["items"]) + 1


def test_the_backward_holds_the_engine_and_the_recompute(runs):
    """On the CPU autograd runs the backward on the calling thread, so its
    engine events and the recomputed blocks' replay (the sparse blocks
    and the neck run again) nest in ``train.backward``; the replay opens
    no model span again, as none lies inside a recomputed block."""
    events = list(runs[True]["prof"].events())
    engine = [e for e in events if e.name.startswith("autograd::engine::evaluate_function: ")]
    assert engine and all(_span(e) == "train.backward" for e in engine)
    replayed = [e for e in events if e.name == "aten::convolution" and _span(e) == "train.backward"]
    assert replayed
    assert sum(e.name == "model.neck" and _span(e) == "train.backward" for e in events) == 0


class _Nested:
    """A stand-in for ``record_function`` that keeps each range's name and
    the name of the range open around it (None at the root)."""

    opened: list = []
    _stack: list = []

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        _Nested.opened.append((self.name, _Nested._stack[-1] if _Nested._stack else None))
        _Nested._stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _Nested._stack.pop()


def test_each_micro_batch_opens_its_forward_and_backward(monkeypatch):
    """With ``accum_steps`` 2 a step opens two forwards and two backwards,
    each holding its model stages' spans, and one ``train.allreduce`` that
    holds the accumulation's divide (spans kept by a stand-in recorder,
    as if a profiler recorded)."""
    cfg = load_experiment(str(FLAGSHIP), NARROW)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
    batch = trainer.batch_to_device(synthetic_batches(cfg, 1, 2, 500, seed=0, n_objects=2, max_points=600)[0],
                                    "cpu")
    _Nested.opened, _Nested._stack = [], []
    divide = torch._foreach_div_
    divided_in = []

    def recorded_divide(*a, **k):
        divided_in.append(_Nested._stack[-1])
        return divide(*a, **k)

    monkeypatch.setattr(profiling, "_autograd_profiler", types.SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(torch.profiler, "record_function", _Nested)
    monkeypatch.setattr(torch, "_foreach_div_", recorded_divide)
    train_step(model, opt, batch, accum_steps=2)
    phases = ["train.forward", "train.backward"] * 2 + ["train.allreduce", "train.optimizer"]
    assert [name for name, parent in _Nested.opened if parent == "train.step"] == phases
    assert [name for name, parent in _Nested.opened if parent is None] == ["train.step"]
    stages = [name for name, parent in _Nested.opened if parent == "train.forward"]
    assert stages == ["model.reader", "model.backbone", "model.neck", "model.head"] * 2
    assert divided_in.count("train.allreduce") == 1  # the optimizer's own divides lie in train.optimizer
    assert set(divided_in) <= {"train.allreduce", "train.optimizer"}


def test_nms_sync_spans_count_the_nms_host_reads(runs):
    syncs = sum(e.name == "nms.sync" for e in runs[True]["prof"].events())
    assert syncs == runs[True]["reads"] > 0
    assert runs[True]["opened"].count("nms.sync") == syncs


def test_without_a_profiler_no_span_is_opened(runs):
    assert runs[False]["opened"] == []
    assert profiling.annotate("train.step") is profiling.annotate("nms")


def test_a_recording_profiler_changes_no_bit(runs):
    plain, traced = runs[False], runs[True]
    for k in ("loss", "grad_norm"):
        assert torch.equal(plain["scalars"][k], traced["scalars"][k]), k
    assert all(torch.equal(a, b) for a, b in zip(plain["params"], traced["params"]))
    for a, b in zip(plain["dets"], traced["dets"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


MVF_TOWER_BLOCKS = 12  # each view's tower: 4 stages of a ConvBlock and 2 ResidualBlocks


def test_mvf_spans_open_in_the_reader_and_the_recompute_reopens_the_tower(monkeypatch):
    """A train step and an eval forward of the narrowed MVF: each of the
    reader's spans opens once a forward in ``model.reader``, the tower's
    once a block in its view and the readback once in each view; in the
    step's backward each recomputed block opens ``mvf.tower`` again, in
    ``train.backward`` (autograd runs the backward on the calling thread on
    the CPU), and no other reader span (spans kept by a stand-in recorder,
    as if a profiler recorded)."""
    from tests.test_torch_port_mvf import MVF, OVERRIDES

    cfg = load_experiment(str(MVF), OVERRIDES)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
    batch = trainer.batch_to_device(synthetic_batches(cfg, 1, 2, 800, seed=0, n_objects=2, max_points=1000)[0],
                                    "cpu")
    monkeypatch.setattr(profiling, "_autograd_profiler", types.SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(torch.profiler, "record_function", _Nested)
    views = {"mvf.views": "model.reader", "mvf.pillar_view": "model.reader",
             "mvf.cylinder_view": "model.reader", "mvf.pointnet": "model.reader", "mvf.bev_max": "model.reader"}
    forward = collections.Counter({**{(n, p): 1 for n, p in views.items()},
                                   ("mvf.tower", "mvf.pillar_view"): MVF_TOWER_BLOCKS,
                                   ("mvf.tower", "mvf.cylinder_view"): MVF_TOWER_BLOCKS,
                                   ("mvf.readback", "mvf.pillar_view"): 1,
                                   ("mvf.readback", "mvf.cylinder_view"): 1})
    for train in (True, False):
        _Nested.opened, _Nested._stack = [], []
        if train:
            train_step(model, opt, batch)
        else:
            model.eval()
            with torch.no_grad():
                model(batch["points"], batch["points_mask"])
        seen = collections.Counter((n, p) for n, p in _Nested.opened if n.startswith("mvf."))
        want = forward + (collections.Counter({("mvf.tower", "train.backward"): 2 * MVF_TOWER_BLOCKS})
                          if train else collections.Counter())
        assert seen == want, (train, seen)
        assert [p for n, p in _Nested.opened if n == "model.reader"] == (["train.forward"] if train else [None])
