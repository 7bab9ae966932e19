"""Import hygiene: the port runs without jax, flax or the JAX package.

The test process itself has imported jax (tests/conftest.py), so the check
runs in a fresh interpreter that imports only the port: it reads the
flagship YAML with the port's own config loader, builds the small
flagship-structured model on the CPU, runs one predict and one train
step, and then requires that no module named ``jax*``, ``flax*``,
``pillarnext_tpu`` or ``pillarnext_tpu.*`` was imported.  Two more
interpreters do the same for a predict of the small voxel18 model and for
a voxel18 train step through the Trainer, one for a predict of the
small MVF model (waymo_det_mvf18_aspp_iou_car) and one for an MVF train
step through the Trainer; a last one imports the CLIs and the data
package and asks both CLIs for ``--help``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys
import torch
import pillarnext_tpu_torch
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.train.trainer import batch_to_device
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
    "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
    "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
    "+model.backbone.out_channels=32", "model.neck.in_channels=32",
    "model.head.in_channels=32", "+model.head.share_conv_channel=32",
])
model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0))
pts, mask = lidar_like_points(1, 2000, pc, seed=0)
out = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))

train_model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
opt, _ = build_optimizer(cfg, 1, list(train_model.parameters()))
batch = synthetic_batches(cfg, 1, 1, 2000, seed=0, n_objects=3, max_points=3000)[0]
scalars, _ = train_step(train_model, opt, batch_to_device(batch, "cpu"))

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({
    "shape": list(out["box3d_lidar"].shape),
    "finite": bool(torch.isfinite(out["box3d_lidar"]).all()),
    "loss_finite": bool(torch.isfinite(scalars["loss"])),
    "step": opt.count,
    "loaded": sorted(m for m in sys.modules if foreign(m)),
}))
"""


def test_port_predict_imports_no_jax():
    flagship = REPO / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(flagship)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["shape"] == [1, 10 * 83, 9]
    assert result["finite"]
    assert result["loss_finite"]
    assert result["step"] == 1
    assert result["loaded"] == []


VOXEL_SCRIPT = r"""
import json, sys
import torch
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,0.2]",
    "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
    "model.backbone.out_channels=16", "model.neck.in_channels=32",
    "model.head.in_channels=32", "+model.head.share_conv_channel=32",
])
model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0))
pts, mask = lidar_like_points(1, 2000, pc, seed=0)
out = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({
    "reader": type(model.reader).__name__,
    "backbone": type(model.backbone).__name__,
    "shape": list(out["box3d_lidar"].shape),
    "finite": bool(torch.isfinite(out["box3d_lidar"]).all()),
    "loaded": sorted(m for m in sys.modules if foreign(m)),
}))
"""


def test_port_voxel18_predict_imports_no_jax():
    voxel18 = REPO / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", VOXEL_SCRIPT, str(voxel18)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (result["reader"], result["backbone"]) == ("VoxelFeatureNet", "SparseResNet3D")
    assert result["shape"] == [1, 10 * 83, 9]
    assert result["finite"]
    assert result["loaded"] == []


VOXEL_TRAIN_SCRIPT = r"""
import json, sys, tempfile
import torch
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment

pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,0.2]",
    "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
    "model.backbone.out_channels=16", "model.neck.in_channels=32",
    "model.head.in_channels=32", "+model.head.share_conv_channel=32",
])
model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
batches = synthetic_batches(cfg, 1, 1, 2000, seed=0, n_objects=3, max_points=3000)
opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
with tempfile.TemporaryDirectory() as work_dir:
    trainer = Trainer(model, batches, opt, sched, max_epochs=1, work_dir=work_dir, device="cpu")
    trainer.fit()

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({
    "backbone": type(model.backbone).__name__,
    "loss_finite": bool(torch.isfinite(trainer.last_scalars["loss"])),
    "step": trainer.step,
    "telemetry": sorted(trainer.last_scalars["telemetry"]),
    "loaded": sorted(m for m in sys.modules if foreign(m)),
}))
"""


def test_port_voxel18_train_step_imports_no_jax():
    """A bf16 voxel18 train step through the Trainer, in a fresh
    interpreter that imports only the port."""
    voxel18 = REPO / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", VOXEL_TRAIN_SCRIPT, str(voxel18)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["backbone"] == "SparseResNet3D"
    assert result["loss_finite"]
    assert result["step"] == 1
    assert "stage1_overflow" in result["telemetry"] and "voxel_overflow" in result["telemetry"]
    assert result["loaded"] == []


MVF_SCRIPT = r"""
import json, sys
import torch
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

pc = [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,20.0]",
    "model.reader.cylinder_size=[5.625,0.375,10.0]",
    "model.reader.cylinder_range=[-180.0,-3.0,0.0,180.0,3.0,10.0]",
    "model.reader.num_filters=[8,8]", "model.reader.ds_num_filters=[8,12,16,16]",
    "model.reader.out_channels=16", "model.reader.pillar_capacity=4096",
    "model.reader.cylinder_capacity=1024", "model.neck.in_channels=16",
    "model.head.in_channels=16", "+model.head.share_conv_channel=16",
])
model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0))
pts, mask = lidar_like_points(1, 2000, pc, seed=0)
out = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({
    "reader": type(model.reader).__name__,
    "backbone": model.backbone is None,
    "shape": list(out["box3d_lidar"].shape),
    "finite": bool(torch.isfinite(out["box3d_lidar"]).all()),
    "loaded": sorted(m for m in sys.modules if foreign(m)),
}))
"""


def test_port_mvf_predict_imports_no_jax():
    mvf = REPO / "pillarnext_tpu/configs/experiments/waymo_det_mvf18_aspp_iou_car.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", MVF_SCRIPT, str(mvf)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (result["reader"], result["backbone"]) == ("MVFFeatureNet", True)
    assert result["shape"] == [1, 3 * 500, 9]
    assert result["finite"]
    assert result["loaded"] == []


MVF_TRAIN_SCRIPT = r"""
import json, sys, tempfile
import torch
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment

pc = [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,20.0]",
    "model.reader.cylinder_size=[5.625,0.375,10.0]",
    "model.reader.cylinder_range=[-180.0,-3.0,0.0,180.0,3.0,10.0]",
    "model.reader.num_filters=[8,8]", "model.reader.ds_num_filters=[8,12,16,16]",
    "model.reader.out_channels=16", "model.reader.pillar_capacity=4096",
    "model.reader.cylinder_capacity=1024", "model.neck.in_channels=16",
    "model.head.in_channels=16", "+model.head.share_conv_channel=16",
])
model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
batches = synthetic_batches(cfg, 1, 1, 2000, seed=0, n_objects=3, max_points=3000)
opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
with tempfile.TemporaryDirectory() as work_dir:
    trainer = Trainer(model, batches, opt, sched, max_epochs=1, work_dir=work_dir, device="cpu")
    trainer.fit()

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({
    "reader": type(model.reader).__name__,
    "loss_finite": bool(torch.isfinite(trainer.last_scalars["loss"])),
    "step": trainer.step,
    "telemetry": sorted(trainer.last_scalars["telemetry"]),
    "loaded": sorted(m for m in sys.modules if foreign(m)),
}))
"""


def test_port_mvf_train_step_imports_no_jax():
    """A bf16 MVF train step through the Trainer (the towers recomputed in
    the backward), in a fresh interpreter that imports only the port."""
    mvf = REPO / "pillarnext_tpu/configs/experiments/waymo_det_mvf18_aspp_iou_car.yaml"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", MVF_TRAIN_SCRIPT, str(mvf)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["reader"] == "MVFFeatureNet"
    assert result["loss_finite"]
    assert result["step"] == 1
    assert result["telemetry"] == ["cylinder_active", "cylinder_overflow", "pillar_active", "pillar_overflow"]
    assert result["loaded"] == []


def test_build_model_and_trainer_default_to_the_card():
    """Without ``device="cpu"`` the entry points ask for ``cuda:0`` and,
    without a card, raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from pillarnext_tpu_torch.train.trainer import Trainer
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(REPO / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg["model"])
    model = build_model(cfg["model"], device="cpu")
    opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(model, [], opt)


CLI_SCRIPT = r"""
import contextlib, io, json, sys, time
t0 = time.perf_counter()
import pillarnext_tpu_torch.cli.test
import pillarnext_tpu_torch.cli.train
import pillarnext_tpu_torch.data

helps = []
for main in (pillarnext_tpu_torch.cli.train.main, pillarnext_tpu_torch.cli.test.main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(["--help"])
        except SystemExit as e:
            code = e.code
    helps.append([code, out.getvalue()])

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({"helps": helps, "seconds": time.perf_counter() - t0,
                  "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


def test_port_cli_imports_no_jax():
    """The CLIs and the data package import, and answer ``--help``, in a
    fresh interpreter without loading JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    (train_code, train_help), (test_code, test_help) = result["helps"]
    assert train_code == test_code == 0
    assert "--load-from" in train_help and "--device" in train_help
    assert "--checkpoint" in test_help and "--device" in test_help
    assert result["loaded"] == []
    assert result["seconds"] < 15
