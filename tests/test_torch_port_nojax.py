"""Import hygiene: the port runs without jax or flax.

The test process itself has imported jax (tests/conftest.py), so the check
runs in a fresh interpreter: import the port, build the small
flagship-structured model on the CPU, run one predict, and require that
neither ``jax`` nor ``flax`` was imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys
import torch
import pillarnext_tpu_torch
from pillarnext_tpu.utils.config import load_experiment
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model

pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
cfg = load_experiment(sys.argv[1], [
    f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
    "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
    "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
    "+model.backbone.out_channels=32", "model.neck.in_channels=32",
    "model.head.in_channels=32", "+model.head.share_conv_channel=32",
])
model = build_model(cfg["model"], generator=torch.Generator().manual_seed(0))
pts, mask = lidar_like_points(1, 2000, pc, seed=0)
out = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))
print(json.dumps({
    "shape": list(out["box3d_lidar"].shape),
    "finite": bool(torch.isfinite(out["box3d_lidar"]).all()),
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")),
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
    assert result["loaded"] == []
