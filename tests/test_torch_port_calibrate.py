"""The port's capacity calibration CLI and the detector presets no
experiment uses (CPU).

- ``python -m pillarnext_tpu_torch.cli.calibrate_capacity`` prints, line
  for line, what ``tools/calibrate_capacity.py`` prints on the same two
  synthetic frames (10k points each) for the flagship, voxel18 and MVF
  experiments: the same occupancies and recommendations.
- The presets under pillarnext_tpu/configs/models/detectors/ that no
  experiment composes (``pointpillars``, the neck-less ``pillarnet18`` and
  ``voxel18``) compose with the port's config loader and build in the
  port with the geometry tests/test_readers_and_configs.py supplies; the
  neck-less pillarnet18 at a 32 x 32 grid, f32, with JAX's random weights
  carried by the port's exporter, predicts what JAX's predicts: the same
  detection set, labels exactly, scores within 1e-3 and boxes within 1e-2
  (tools/flagship_parity.py's bars).
"""

from __future__ import annotations

import contextlib
import io
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_config as jax_load_config
from pillarnext_tpu.utils.config import resolve as jax_resolve
from pillarnext_tpu_torch.cli import calibrate_capacity
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_config, resolve
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_port_e2e import randomized_variables
from tests.test_torch_port_head_options import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "pillarnext_tpu/configs"
EXPERIMENTS = ["nusc_det_pp18_aspp_iou_sp", "nusc_det_voxel18_aspp_iou_sp", "waymo_det_mvf18_aspp_iou_car"]


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_calibrate_capacity_prints_what_the_jax_tool_prints(experiment, monkeypatch):
    args = ["--config", str(CONFIGS / "experiments" / f"{experiment}.yaml"), "--frames", "2", "--points", "10000"]
    want = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["calibrate_capacity.py", *args])
    with contextlib.redirect_stdout(want):
        runpy.run_path(str(REPO / "tools/calibrate_capacity.py"), run_name="__main__")
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        calibrate_capacity.main(args)
    assert "recommended" in want.getvalue()
    assert got.getvalue() == want.getvalue()


PC = [-3.2, -3.2, -5.0, 3.2, 3.2, 3.0]
POST = {
    "post_center_limit_range": [-5.0, -5.0, -10.0, 5.0, 5.0, 10.0], "nms_type": "iou3d",
    "nms": {"nms_pre_max_size": 100, "nms_post_max_size": 20, "nms_iou_threshold": [[0.2]]},
    "score_threshold": 0.1, "pc_range": PC, "voxel_size": [0.2, 0.2, 8.0], "out_size_factor": [4],
}


def preset(name: str, load=load_config, res=resolve) -> dict:
    """A detector preset with the geometry of
    tests/test_readers_and_configs.py (one task, a 32 x 32 grid), f32."""
    cfg = res(load(CONFIGS / "models" / "detectors" / f"{name}.yaml"))
    voxel = name == "voxel18"
    cfg["reader"].update(voxel_size=[0.2, 0.2, 0.2] if voxel else [0.2, 0.2, 8.0], pc_range=PC)
    if voxel:
        cfg["reader"]["voxel_capacity"] = 2048
        cfg["backbone"]["num_input_features"] = cfg["reader"]["num_input_features"]
        in_ch = 2 * cfg["backbone"].get("out_channels", 128)  # 40 levels fold to 2
    else:
        cfg["reader"]["pillar_capacity"] = 2048
        cfg["backbone"]["num_input_features"] = cfg["reader"]["num_filters"][-1]
        in_ch = cfg["backbone"].get("out_channels", 256)
    if "neck" in cfg:
        cfg["neck"]["in_channels"] = in_ch
    cfg["head"].update(tasks=[["car"]], in_channels=256 if "neck" in cfg else in_ch, weight=0.25,
                       code_weights=[1.0] * 10, strides=[2], rectifier=[[0.5]], voxel_size=cfg["reader"]["voxel_size"],
                       pc_range=PC, out_size_factor=[4])
    cfg["dtype"] = "float32"
    cfg["post_processing"] = dict(POST, voxel_size=cfg["reader"]["voxel_size"])
    return cfg


@pytest.mark.parametrize("name", ["pointpillars", "pillarnet18", "voxel18"])
def test_unused_presets_build_in_the_port(name):
    model = build_model(preset(name), device="cpu", generator=torch.Generator().manual_seed(0))
    assert (model.neck is None) == (name != "pointpillars")
    pts, mask = lidar_like_points(1, 2000, PC, seed=0)
    with torch.no_grad():
        out = model.predict(torch.from_numpy(pts), torch.from_numpy(mask))
    assert out["box3d_lidar"].shape == (1, 20, 9) and torch.isfinite(out["box3d_lidar"]).all()


def test_pillarnet18_predict_matches_jax():
    cfg = preset("pillarnet18", jax_load_config, jax_resolve)
    pts, mask = lidar_like_points(2, 3000, PC, seed=1)
    jmodel = jax_builders.build_model(cfg)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    variables = randomized_variables(init)
    ref = jax.jit(lambda v, p, m: jmodel.apply(v, {"points": p, "points_mask": m}, method=jmodel.predict))(
        variables, jnp.asarray(pts), jnp.asarray(mask))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = load_jax_variables(build_model(preset("pillarnet18"), device="cpu"), variables)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model.predict(torch.from_numpy(pts), torch.from_numpy(mask)).items()}
    assert ref["valid"].sum() >= 8, "vacuous: too few detections"
    for i in range(2):
        gv, rv = got["valid"][i], ref["valid"][i].astype(bool)
        assert gv.sum() == rv.sum()
        go = np.lexsort((-got["scores"][i][gv], got["label_preds"][i][gv]))
        ro = np.lexsort((-ref["scores"][i][rv], ref["label_preds"][i][rv]))
        np.testing.assert_array_equal(got["label_preds"][i][gv][go], ref["label_preds"][i][rv][ro])
        np.testing.assert_allclose(got["scores"][i][gv][go], ref["scores"][i][rv][ro], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got["box3d_lidar"][i][gv][go], ref["box3d_lidar"][i][rv][ro], atol=1e-2, rtol=0)
