"""The port's measurement tools and the multi-host launcher, on the CPU at
small sizes (the narrowed flagship: +-8 m, 0.25 m pillars, narrow widths).

- ``eval_breakdown``: each prefix's output is the bits of the matching
  intermediate of the port's own ``extract_feat`` (masked and unmasked);
  the last prefix lies within 1e-4 (relative to its largest entry, f32) of
  JAX's ``extract_feat`` with the same variables.
- ``train_breakdown``: its record (the rows' losses and gradients against
  JAX's truncated models are in tests/test_torch_port_train_breakdown.py).
- ``loader_bench``: the port's ``make_synthetic_nusc`` writes JAX's files
  byte for byte; ``run`` at 0 and 2 workers returns its fields.
- ``baseline_probe``: the probe's detections pass ``compare_detections``
  before any timing, and a mirror whose weights moved makes it raise.
- ``dist_train_waymo.sh``: ``NUM_PROCESSES=1 NPROC_PER_NODE=2`` over gloo
  on the CPU, one epoch of the narrowed Waymo pp18 on a small tree; both
  ranks finish and load no JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu_torch.models import resnet
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from pillarnext_tpu_torch.tools import baseline_probe, eval_breakdown, loader_bench, parity, train_breakdown
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES, PC
from tests.test_torch_port_train import random_variables
from tests.test_torch_port_waymo_e2e import NARROWED
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

B, N = 2, 3000
# the mirror's head is 64 wide: the narrowed flagship keeps share_conv_channel
PROBE_OVERRIDES = [o for o in OVERRIDES if "share_conv_channel" not in o]


def _frame(batch=B):
    pts, mask = lidar_like_points(batch, N, PC, seed=0)
    return pts, mask


def _jax_variables(jmodel, pts, mask, seed=0):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    return random_variables(shapes, seed)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


# ---------------------------------------------------------------- eval_breakdown

def _extract_feat_steps(model, pts, mask, monkeypatch) -> list:
    """The intermediates of ``model.extract_feat`` at the breakdown's cuts:
    the reader's table, each SubM stage's rows, the densified map, each
    dense stage's output, the backbone's and the neck's."""
    got, bb = [], model.backbone
    real_stage, real_dense = resnet.sparse_stage, SparseBEV.to_dense

    def stage(*args, **kwargs):
        got.append(real_stage(*args, **kwargs))
        return got[-1]

    def to_dense(self, *args, **kwargs):
        got.append(real_dense(self, *args, **kwargs))
        return got[-1]

    monkeypatch.setattr(resnet, "sparse_stage", stage)
    monkeypatch.setattr(SparseBEV, "to_dense", to_dense)
    hooks = [model.reader.register_forward_hook(lambda m, a, out: got.append(out.table))]
    hooks += [bb.blocks[i][-1].register_forward_hook(lambda m, a, out: got.append(out))
              for i in range(bb.n_sparse, len(bb.layer_nums))]
    hooks += [mod.register_forward_hook(lambda m, a, out: got.append(out)) for mod in (bb, model.neck)]
    try:
        with torch.inference_mode():
            model.extract_feat(pts, mask)
    finally:
        for h in hooks:
            h.remove()
        monkeypatch.undo()
    return got


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_eval_breakdown_prefixes_are_extract_feat_intermediates(masked, monkeypatch):
    cfg = load_experiment(FLAGSHIP, [*OVERRIDES, f"model.backbone.masked_eval={str(masked).lower()}"])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = (torch.from_numpy(a) for a in _frame())
    want = _extract_feat_steps(model, pts, mask, monkeypatch)
    names = eval_breakdown.step_names(model)
    assert names == ["reader", "+stage0", "+densify", "+stage1", "+stage2", "+stage3", "+1x1", "+neck"]
    assert len(want) == len(names)
    with torch.inference_mode():
        for upto, name in enumerate(names):
            got = eval_breakdown.prefix(model, upto, pts, mask)
            if name == "reader":
                got = got.table
            elif name == "+densify":  # as it enters the first dense block
                got = got.permute(0, 2, 3, 1)
            assert got.shape == want[upto].shape and torch.equal(got, want[upto]), name
    assert resnet.sparse_stage is eval_breakdown.resnet.sparse_stage and not model.reader._forward_hooks


def test_eval_breakdown_raises_where_the_forward_never_reaches_a_cut():
    """The ``all`` mode runs every stage over compact tables and densifies
    only at the end: its forward enters no dense block, so the
    ``+densify`` cut raises instead of timing the whole model."""
    cfg = load_experiment(FLAGSHIP, [*OVERRIDES, "+model.backbone.sparse_stages_eval=all"])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = (torch.from_numpy(a) for a in _frame())
    with torch.inference_mode():
        assert eval_breakdown.prefix(model, 1, pts, mask).dim() == 2  # stage 0 still cuts: table rows
        with pytest.raises(ValueError, match="never reached step '\\+densify'"):
            eval_breakdown.prefix(model, 2, pts, mask)
    assert resnet.sparse_stage is eval_breakdown.resnet.sparse_stage


def test_eval_breakdown_last_prefix_matches_jax():
    cfg = load_experiment(FLAGSHIP, OVERRIDES)["model"]
    pts, mask = _frame()
    jmodel = jax_builders.build_model(cfg)
    variables = _jax_variables(jmodel, pts, mask)
    want = np.asarray(jax.jit(lambda v, p, m: jmodel.apply(v, p, m, False, method=jmodel.extract_feat))(
        variables, jnp.asarray(pts), jnp.asarray(mask)))
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    names = eval_breakdown.step_names(model)
    with torch.inference_mode():
        got = eval_breakdown.prefix(model, len(names) - 1, torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_eval_breakdown_run_reports_every_prefix():
    rec = eval_breakdown.run(batch=1, points=N, reps=2, device="cpu", overrides=OVERRIDES, log=lambda s: None)
    assert [r["name"] for r in rec["rows"]][-1] == "+neck" and len(rec["rows"]) == 8
    assert rec["card"] is None and all(r["device_ms"] is None for r in rec["rows"])
    assert all(r["ms"] > 0 and set(r["launches"]) == {"pfn_two_layer", "monotone_row_gather",
                                                      "sorted_segment_bcast", "card_greedy_nms"}
               for r in rec["rows"])


# ---------------------------------------------------------------- train_breakdown

def test_train_breakdown_run_reports_every_row(monkeypatch):
    monkeypatch.setattr(train_breakdown, "ROWS", train_breakdown.ROWS[:2])
    rec = train_breakdown.run(batch=1, points=N, steps=1, device="cpu", overrides=OVERRIDES, log=lambda s: None)
    reader, stage0 = rec["rows"]
    assert (reader["name"], stage0["name"]) == ("reader", "+stage0")
    assert stage0["delta_step_ms"] == pytest.approx(stage0["step_ms"] - reader["step_ms"])
    assert reader["device_forward_ms"] is None and reader["peak_mb"] is None and reader["grad_abs_sum"] > 0


# ---------------------------------------------------------------- loader_bench

def _jax_loader_bench():
    spec = importlib.util.spec_from_file_location("jax_loader_bench", REPO / "tools/loader_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_loader_bench_tree_is_jax_tree(tmp_path):
    jax_tool = _jax_loader_bench()
    jax_tool.make_synthetic_nusc(tmp_path / "jax", 2, pts_per_sweep=500)
    loader_bench.make_synthetic_nusc(tmp_path / "port", 2, pts_per_sweep=500)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 2 * 10 + len(loader_bench.CLASSES) * 32 + 2
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_loader_bench_run_returns_its_fields(tmp_path):
    """One trip a worker: 1 warm and 2 timed batches at 0 workers, 2 and 2
    at 2; the tree holds the 4 batches of 4 that 2 workers need."""
    rec = loader_bench.run(workers=[0, 2], max_points=8000, step_ms=400.0, root=tmp_path, pts_per_sweep=500,
                           trips=1, log=lambda s: None)
    assert rec["samples"] == 16 and rec["step_frames_per_s"] == pytest.approx(10.0)
    assert [(r["workers"], r["warm_batches"], r["batches"]) for r in rec["rates"]] == [(0, 1, 2), (2, 2, 2)]
    for r in rec["rates"]:
        assert r["frames_per_s"] == pytest.approx(4 * r["batches_per_s"]) and r["worker_s_per_batch"] > 0
        assert r["keeps_up"] == (r["frames_per_s"] >= 10.0)
    assert loader_bench.samples_needed([0, 2, 4, 8], 4, 4) == 4 * (8 + 4 * 8)
    with pytest.raises(ValueError, match="fewer than the 16"):
        loader_bench.run(n_samples=15, workers=[2], trips=1, root=tmp_path)


# ---------------------------------------------------------------- baseline_probe

def test_baseline_probe_checks_then_times():
    rec = baseline_probe.run(runs=1, points=N, device="cpu", overrides=PROBE_OVERRIDES, log=lambda s: None)
    assert rec["check"]["same_label"] >= parity.RANDOM_MIN_MATCHED and rec["check"]["ref"] == rec["check"]["ours"]
    assert rec["mirror_over_port"] == pytest.approx(rec["mirror_ms"] / rec["port_ms"])
    assert rec["card"] is None and len(rec["mirror_ms_all"]) == len(rec["port_ms_all"]) == 1


def test_baseline_probe_raises_on_a_broken_mirror(monkeypatch):
    """A mirror whose weights moved after the port took them computes
    another function: the probe raises before it times anything."""
    from pillarnext_tpu_torch.tools import flagship_parity
    from pillarnext_tpu_torch.utils import profiling

    real = flagship_parity.random_pair

    def broken(mcfg, seed, device):
        model, tmodel = real(mcfg, seed, device)
        with torch.no_grad():
            for p in tmodel.parameters():
                p.mul_(1.5)
        return model, tmodel

    timed = []
    monkeypatch.setattr(flagship_parity, "random_pair", broken)
    monkeypatch.setattr(profiling, "synced_ms", lambda *a: timed.append(a))
    with pytest.raises(AssertionError, match="parity|count mismatch"):
        baseline_probe.run(runs=1, points=N, device="cpu", overrides=PROBE_OVERRIDES, log=lambda s: None)
    assert timed == []


# ---------------------------------------------------------------- dist_train_waymo.sh

def waymo_tree(root: Path, monkeypatch) -> tuple[list, list]:
    """A small Waymo tree (``chip_smoke.write_waymo_tree`` at 4,000 points a
    frame) with its GT database, and the overrides that train the narrowed
    Waymo pp18 on it: (overrides, val tokens)."""
    path, pc, narrow = NARROWED["pp18"]
    monkeypatch.setattr(chip_smoke, "N_POINTS", 4000)
    names = [n for task in load_experiment(path)["data"]["train_dataset"]["class_names"] for n in task]
    tree = chip_smoke.write_waymo_tree(root, pc, names, seed=1)
    chip_smoke.gt_database("waymo", root, "waymo_infos_train.pkl", 1, names)
    overrides = [f"data.train_dataset.root_path={root}", f"model.reader.pc_range={pc}", *narrow,
                 f"model.post_processing.post_center_limit_range={[pc[0] - 2, pc[1] - 2, -10, pc[3] + 2, pc[4] + 2, 10]}",
                 "model.post_processing.nms.nms_pre_max_size=64", "model.post_processing.nms.nms_post_max_size=16",
                 "dataloader.train.num_workers=0", "dataloader.val.num_workers=0", "dataloader.max_points=12000",
                 "trainer.max_epochs=1"]
    return overrides, tree["tokens"]["val"]


def test_dist_train_waymo_launcher_on_two_gloo_ranks(tmp_path, monkeypatch):
    overrides, val_tokens = waymo_tree(tmp_path / "waymo", monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out, work = tmp_path / "ranks", tmp_path / "work"
    out.mkdir()
    ranks = chip_smoke.run_launcher(out, ["--device", "cpu", "--dist-backend", "gloo", "--work-dir", str(work),
                                          *overrides], nproc_per_node=2, timeout_s=240)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["foreign_modules"] == [] for r in ranks)
    meta = torch.load(work / "checkpoints/epoch_1.pt", map_location="cpu", weights_only=True)["meta"]
    # 8 train frames over 2 ranks at the launcher's 3 a rank: one step
    assert meta == {"epoch": 1, "step": 1}
    exported = np.load(work / "results/epoch_1/waymo_preds.npz", allow_pickle=True)["tokens"]
    assert sorted(str(t) for t in exported) == sorted(val_tokens)
    # the CLI got the launcher's config and overrides, then the caller's
    argv = ranks[0]["argv"]
    assert argv[0].endswith("pillarnext_tpu_torch/cli/train.py") and ranks[1]["argv"] == argv
    i = argv.index("--config")
    assert argv[i + 1].endswith("pillarnext_tpu/configs/experiments/waymo_det_pp18_aspp_iou_car_sp.yaml")
    assert argv[i + 2:i + 5] == ["dataloader.train.batch_size=3", "scheduler.max_lr=0.006", "trainer.max_epochs=36"]
    assert argv[i + 5:] == ["--device", "cpu", "--dist-backend", "gloo", "--work-dir", str(work), *overrides]
