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
step through the Trainer; a last one imports the CLIs, the data package
and ``parallel``, asks both CLIs for ``--help`` and forms a 1-rank gloo
group whose all-reduce it checks.  Four more import each offline
data-preparation module (``cli.create_data``, ``cli.create_gt_database``,
``data.nusc_converter``, ``data.waymo_converter``) with every devkit
import made to fail.  Each child runs torch on one thread
(``OMP_NUM_THREADS=1``): the suite runs several test processes on the
machine's cores.
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
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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
import contextlib, io, json, os, socket, sys, time
t0 = time.perf_counter()
import pillarnext_tpu_torch.cli.test
import pillarnext_tpu_torch.cli.train
import pillarnext_tpu_torch.data
import pillarnext_tpu_torch.parallel as parallel

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

seconds = time.perf_counter() - t0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
import torch
device = parallel.init_from_env("gloo", "cpu", timeout_s=60)
summed = parallel.all_reduce_sum(torch.tensor([1.0, 2.0]))
group = [str(device), parallel.is_distributed(), parallel.rank(), parallel.world_size(), summed.tolist()]
parallel.shutdown()

print(json.dumps({"helps": helps, "seconds": seconds, "group": group,
                  "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


def test_port_cli_imports_no_jax():
    """The CLIs, the data package and ``parallel`` import, the CLIs answer
    ``--help`` and a 1-rank gloo group forms and all-reduces, in a fresh
    interpreter without loading JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    (train_code, train_help), (test_code, test_help) = result["helps"]
    assert train_code == test_code == 0
    assert "--load-from" in train_help and "--device" in train_help
    assert "--checkpoint" in test_help and "--device" in test_help
    assert "--dist-backend" in train_help and "--dist-backend" in test_help
    assert result["group"] == ["cpu", True, 0, 1, [1.0, 2.0]]
    assert result["loaded"] == []
    assert result["seconds"] < 15


DATAPREP_SCRIPT = r"""
import contextlib, importlib, io, json, sys
DEVKITS = ("nuscenes", "pyquaternion", "waymo_open_dataset", "tensorflow")
for name in DEVKITS:
    sys.modules[name] = None  # any import of a devkit now raises ImportError
module = importlib.import_module(sys.argv[1])

calls = {}
if hasattr(module, "main"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            module.main(["--help"])
        except SystemExit as e:
            calls["help"] = [e.code, out.getvalue()]
for name, args in (("create_nuscenes_infos", ("/nonexistent",)), ("convert", ("/nonexistent", "/nonexistent"))):
    if hasattr(module, name):
        try:
            getattr(module, name)(*args)
        except ImportError as e:
            calls[name] = str(e)

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({"calls": calls, "loaded": sorted(m for m in sys.modules if foreign(m)),
                  "devkits": sorted(m for m in sys.modules if m.split(".")[0] in DEVKITS and sys.modules[m])}))
"""


@pytest.mark.parametrize("module", [
    "pillarnext_tpu_torch.cli.create_data",
    "pillarnext_tpu_torch.cli.create_gt_database",
    "pillarnext_tpu_torch.cli.calibrate_capacity",
    "pillarnext_tpu_torch.data.nusc_converter",
    "pillarnext_tpu_torch.data.waymo_converter",
])
def test_port_dataprep_imports_no_jax_and_no_devkit(module):
    """Each offline data-preparation module imports in a fresh interpreter
    where every devkit import fails (nuscenes, pyquaternion,
    waymo_open_dataset, tensorflow), loads no JAX or JAX package, answers
    ``--help`` where it is a CLI, and its converter raises an ImportError
    that names the devkit at the call."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DATAPREP_SCRIPT, module], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == [] and result["devkits"] == []
    calls = result["calls"]
    if module.startswith("pillarnext_tpu_torch.cli."):
        code, text = calls["help"]
        assert code == 0 and ("waymo_data_prep" if module.endswith("create_data") else "--root-path") in text
    elif module.endswith("nusc_converter"):
        assert "nuscenes devkit is required" in calls["create_nuscenes_infos"]
    else:
        assert "waymo_open_dataset are required" in calls["convert"]


MODULE_SCRIPT = r"""
import json, sys
import torch
mod = sys.argv[1]
if mod.endswith("tile_subm"):
    from pillarnext_tpu_torch.ops import tile_subm
    from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
    ids = torch.tensor([0, 1, 9, 40, 200, 255, 256 + 17], dtype=torch.int32)
    _, _, slot_id, _ = compactify(ids, 2 * 256, 16)
    sod, _ = invert_slot_map(slot_id, 2 * 256)
    tm = tile_subm.build_tile_map(sod, slot_id, 2, (16, 16), 16, 8, 8)
    table = torch.randn(17, 4, requires_grad=True)
    stack = tile_subm.pack_stack(table, tm)
    y = tile_subm.tile_conv(stack, tm, torch.randn(5, 4, 3, 3))
    (tile_subm.unpack_stack(y, tm).sum() + tile_subm.stack_to_dense(y, tm).sum()).backward()
    result = {"tiles": int(tm.n_tiles), "grad": bool(torch.isfinite(table.grad).all())}
else:
    from pillarnext_tpu_torch.train.train_state import make_optimizer, train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.moderate import beam_batch, moderate_detector
    from pillarnext_tpu_torch.utils.weights import init_random
    model = moderate_detector(tile_stride1=True)
    with torch.no_grad():
        init_random(model, torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(list(model.parameters()), max_lr=1e-3, total_steps=2)
    scalars, _ = train_step(model.train(), opt, batch_to_device(beam_batch(batch=1, n_points=3000), "cpu"))
    result = {"loss": float(scalars["loss"]), "overflow": int(scalars["overflow"])}

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({"result": result, "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


@pytest.mark.parametrize("module", ["pillarnext_tpu_torch.ops.tile_subm", "pillarnext_tpu_torch.utils.moderate"])
def test_port_tile_and_moderate_modules_import_no_jax(module):
    """``ops/tile_subm`` (a tile map, a tile conv and its backward) and
    ``utils/moderate`` (a tile_stride1 train step of the moderate detector)
    run in a fresh interpreter that loads no JAX or JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", MODULE_SCRIPT, module], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    if module.endswith("tile_subm"):
        assert result["result"] == {"tiles": 4, "grad": True}
    else:
        assert result["result"]["overflow"] == 0 and result["result"]["loss"] == result["result"]["loss"]


OPTIONS = {
    "head_unfused": ["+model.head.fuse_eval=false"],
    "merge_branches": ["+model.head.merge_branches=true"],
    "merge_tasks": ["+model.head.merge_tasks=true"],
    "pfn_unfused": ["+model.reader.fuse_eval=false"],
    "pfn3": ["model.reader.num_filters=[16,16,16]"],
    "circle_nms": ["model.post_processing.nms_type=circle"],
    "approx_topk": ["model.post_processing.approx_topk=true"],
    "voxel_dense": ["+model.reader.output=dense"],
}

OPTIONS_SCRIPT = r"""
import contextlib, io, json, sys
import torch
from pillarnext_tpu_torch.cli import calibrate_capacity
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

flagship, voxel18, options = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
narrow = {
    flagship: [f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
               "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
               "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
               "+model.backbone.out_channels=32", "model.neck.in_channels=32",
               "model.head.in_channels=32", "+model.head.share_conv_channel=32"],
    voxel18: [f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.5,0.5,0.2]",
              "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
              "model.backbone.out_channels=16", "model.neck.in_channels=32",
              "model.head.in_channels=32", "+model.head.share_conv_channel=32"],
}
pts, mask = lidar_like_points(1, 2000, pc, seed=0)
results = {}
for name, overrides in options.items():
    path = voxel18 if name == "voxel_dense" else flagship
    cfg = load_experiment(path, narrow[path] + overrides)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))
    results[name] = [list(out["box3d_lidar"].shape), bool(torch.isfinite(out["box3d_lidar"]).all())]
text = io.StringIO()
with contextlib.redirect_stdout(text):
    calibrate_capacity.main(["--config", flagship, "--frames", "1", "--points", "2000"])

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({"results": results, "calibrate": text.getvalue(),
                  "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


@pytest.fixture(scope="module")
def options_run():
    """One fresh interpreter that imports only the port: a predict of the
    narrowed flagship (voxel18 for the dense volume) with each option of
    ``OPTIONS``, then the capacity calibration CLI on one synthetic frame."""
    configs = REPO / "pillarnext_tpu/configs/experiments"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", OPTIONS_SCRIPT, str(configs / "nusc_det_pp18_aspp_iou_sp.yaml"),
         str(configs / "nusc_det_voxel18_aspp_iou_sp.yaml"), json.dumps(OPTIONS)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("option", [*OPTIONS, "calibrate_capacity"])
def test_port_options_import_no_jax(option, options_run):
    """A predict with each option the port gained beside the defaults (the
    head unfused and merged, the PFN stack, circle NMS, approx_topk, the
    dense voxel volume), and the calibration CLI, load no JAX or JAX
    package."""
    assert options_run["loaded"] == []
    if option == "calibrate_capacity":
        assert "recommended reader.pillar_capacity" in options_run["calibrate"]
        return
    shape, finite = options_run["results"][option]
    assert shape[0] == 1 and shape[2] == 9 and finite


LEARNING_SCRIPT = r"""
import contextlib, io, json, sys, tempfile
from pathlib import Path
import torch
from pillarnext_tpu_torch.cli import import_checkpoint
from pillarnext_tpu_torch.data.synthetic import synthetic_batches
from pillarnext_tpu_torch.tools import metric_delta, overfit_sanity
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.train.trainer import batch_to_device
from pillarnext_tpu_torch.utils import profiling
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import write_synthetic_nusc

flagship = sys.argv[1]
pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
narrow = [f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
          "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
          "+model.reader.train_pillar_capacity=4096",
          "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
          "+model.backbone.out_channels=32", "model.neck.in_channels=32",
          "model.head.in_channels=32", "+model.head.share_conv_channel=32"]
results = {}
# training recomputes each sparse block and the neck, with and without the policy
losses = []
for save in ("true", "false"):
    cfg = load_experiment(flagship, narrow + [f"+model.backbone.remat_save_conv_out={save}"])
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    opt, _ = build_optimizer(cfg, 1, list(model.parameters()))
    batch = synthetic_batches(cfg, 1, 1, 2000, seed=0, n_objects=3, max_points=3000)[0]
    timer = profiling.StepTimer(device="cpu")
    timer.tick()
    with profiling.annotate("step"):
        scalars, _ = train_step(model, opt, batch_to_device(batch, "cpu"))
    losses.append(float(scalars["loss"]))
    results["profiling"] = timer.tick() > 0
results["recompute"] = losses
tmp = Path(tempfile.mkdtemp())
sd = {"module." + k: v for k, v in build_model(cfg["model"], device="cpu",
      generator=torch.Generator().manual_seed(1)).state_dict().items()}
torch.save({"state_dict": sd}, tmp / "reference.pth")
with contextlib.redirect_stdout(io.StringIO()):
    path = import_checkpoint.main(["--config", flagship, "--torch-checkpoint", str(tmp / "reference.pth"),
                                   "--out", str(tmp / "imported"), "--device", "cpu", *narrow])
results["import_checkpoint"] = sorted(torch.load(path, weights_only=True))
results["write_synthetic_nusc"] = write_synthetic_nusc(tmp / "synth", 1, n_points=2000, n_objects=2).name
with contextlib.redirect_stdout(io.StringIO()):
    r = overfit_sanity.run(flagship, 2, "cpu", narrow, extent=8.0, n_points=7000, log=lambda s: None)
results["overfit_sanity"] = len(r["losses"])
with contextlib.redirect_stdout(io.StringIO()) as text:
    try:
        metric_delta.main(["--help"])
    except SystemExit:
        pass
results["metric_delta"] = "--scenes" in text.getvalue()

def foreign(name):
    top = name.split(".")[0]
    return top.startswith("jax") or top.startswith("flax") or top == "pillarnext_tpu"

print(json.dumps({"results": results, "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


@pytest.fixture(scope="module")
def learning_run():
    """One fresh interpreter that imports only the port: a train step of
    the narrowed flagship with and without ``remat_save_conv_out`` (each
    sparse block and the neck recomputed) timed by ``profiling``, the
    reference-checkpoint import CLI, the synthetic nuScenes writer, two
    steps of ``tools.overfit_sanity`` and ``tools.metric_delta --help``."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", LEARNING_SCRIPT,
         str(REPO / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("entry", ["recompute", "profiling", "import_checkpoint", "write_synthetic_nusc",
                                   "overfit_sanity", "metric_delta"])
def test_port_learning_entry_points_import_no_jax(entry, learning_run):
    """The recomputed train step, ``utils.profiling``, ``cli.import_checkpoint``,
    ``utils.synth.write_synthetic_nusc`` and the two learning tools load no
    JAX or JAX package."""
    assert learning_run["loaded"] == []
    result = learning_run["results"][entry]
    if entry == "recompute":
        assert len(result) == 2 and result[0] == result[1]  # the policy changes what is kept, not the step
    elif entry == "import_checkpoint":
        assert result == ["meta", "model", "opt_state"]
    elif entry == "write_synthetic_nusc":
        assert result == "infos_synth.pkl"
    elif entry == "overfit_sanity":
        assert result == 2
    else:
        assert result is True


PARITY_TOOL_SCRIPT = r"""
import importlib, json, sys
import torch
from pillarnext_tpu_torch.tools import parity
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment

name, overrides = sys.argv[1], json.loads(sys.argv[2])
tool = importlib.import_module(f"pillarnext_tpu_torch.tools.{name}")
if name == "flagship_parity":
    rec = tool.main(["--device", "cpu", "--points", "1500", *overrides])
else:
    # the trained-weight path with a train-mode model's weights, its head maps held
    cfg = load_experiment(tool.CONFIG, overrides)
    model = build_model(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0), train=True)
    pts, _, _ = parity.planted_scene(cfg["model"], 1500, 0)
    scene = (torch.from_numpy(pts[None]), torch.ones(1, len(pts), dtype=torch.bool))
    rec = tool.run(device="cpu", overrides=overrides, heads=True, trained=(model.state_dict(), scene))

def foreign(name):
    top = name.split(".")[0]
    return top.startswith(("jax", "flax", "tests", "torch_mirror")) or top == "pillarnext_tpu"

print(json.dumps({"mode": rec["mode"], "heads": "heads" in rec,
                  "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


@pytest.mark.parametrize("tool", ["flagship_parity", "voxel_parity", "mvf_parity"])
def test_parity_tool_imports_no_jax(tool):
    """Each full-scale parity tool, at a small grid on the CPU (the
    flagship's random-weight verdict through its CLI, voxel18's and MVF's
    trained-weight path with a train-mode model's weights, holding the head
    maps), in a fresh interpreter that loads no module of JAX, flax, the
    JAX package, the tests or their mirrors."""
    from tests.test_torch_port_parity_tools import FAMILIES

    family = {"flagship_parity": "flagship", "voxel_parity": "voxel18", "mvf_parity": "mvf"}[tool]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", PARITY_TOOL_SCRIPT, tool, json.dumps(FAMILIES[family][1])],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (result["mode"], result["heads"]) == (("random", False) if tool == "flagship_parity" else ("trained", True))
    assert result["loaded"] == []


MEASUREMENT_TOOL_SCRIPT = r"""
import contextlib, io, json, sys, tempfile
from pillarnext_tpu_torch.tools import baseline_probe, eval_breakdown, loader_bench, train_breakdown

narrow, probe = json.loads(sys.argv[1]), json.loads(sys.argv[2])
small = ["--device", "cpu", "--points", "2000"]
results = {}
with contextlib.redirect_stdout(io.StringIO()):
    results["eval_breakdown"] = len(eval_breakdown.main([*small, "--reps", "1", *narrow])["rows"])
    results["train_breakdown"] = len(train_breakdown.main([*small, "--batch", "1", "--steps", "1", *narrow])["rows"])
    results["baseline_probe"] = baseline_probe.main([*small, "--runs", "1", *probe])["check"]["same_label"]
    with tempfile.TemporaryDirectory() as root:
        rec = loader_bench.run(workers=[0], max_points=8000, root=root, pts_per_sweep=500, trips=1,
                               log=lambda s: None)
    results["loader_bench"] = rec["rates"][0]["batches"]

def foreign(name):
    top = name.split(".")[0]
    return top.startswith(("jax", "flax")) or top == "pillarnext_tpu"

print(json.dumps({"results": results, "loaded": sorted(m for m in sys.modules if foreign(m))}))
"""


@pytest.fixture(scope="module")
def measurement_run():
    """One fresh interpreter that imports only the port and runs each
    measurement tool on the CPU at a small grid (the CLIs of
    ``eval_breakdown``, ``train_breakdown`` and ``baseline_probe``,
    ``loader_bench.run`` at no worker, one trip: a tree of 12 samples)."""
    from tests.test_torch_port_e2e import OVERRIDES

    probe = [o for o in OVERRIDES if "share_conv_channel" not in o]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", MEASUREMENT_TOOL_SCRIPT, json.dumps(OVERRIDES), json.dumps(probe)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tool", ["eval_breakdown", "train_breakdown", "baseline_probe", "loader_bench"])
def test_measurement_tool_imports_no_jax(tool, measurement_run):
    """Each measurement tool runs to its record and loads no JAX or JAX
    package."""
    assert measurement_run["loaded"] == []
    want = {"eval_breakdown": 8, "train_breakdown": 7, "loader_bench": 2}
    result = measurement_run["results"][tool]
    assert result >= 0.85 if tool == "baseline_probe" else result == want[tool]


def test_dist_train_waymo_launcher_imports_no_jax(tmp_path):
    """The multi-host launcher's rank (torchrun, one node, one process)
    loads the training CLI, asked for its help, and no JAX or JAX
    package."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rank, = chip_smoke.run_launcher(tmp_path, ["--help"], timeout_s=120)
    assert "pillarnext_tpu_torch/cli/train.py" in rank["argv"][0] and rank["argv"][-1] == "--help"
    assert rank["foreign_modules"] == []
