"""The port's two-task Waymo serving paths vs the JAX package, on the CPU.

- The Waymo YAMLs of the two ported families, narrowed: pp18
  (waymo_det_pp18_aspp_iou_car_sp, +-8 m at 0.25 m pillars as
  tests/test_torch_port_e2e.py) and voxel18 (waymo_det_voxel18_aspp_iou_car,
  +-8 m at 0.25 m with the config's 40 levels of 0.15 m in z, as
  tests/test_torch_port_voxel_e2e.py), narrow widths, float32, through JAX
  ``build_model`` + ``predict`` and the port's ``build_model`` +
  ``AdaptivePredictor``, JAX weights carried across.  Bars: those two
  files' (scores 2e-3 / 1e-3, boxes 2e-2 / 1e-3), the same detection set.
  Both run the Waymo head: two tasks [vehicle], [pedestrian, cyclist],
  ``rectifier`` [[0.68], [0.71, 0.65]], per-class NMS thresholds
  [[0.7], [0.2, 0.25]], ``nms_pre_max_size`` 4096 (capped at the 16 x 16
  map's 256 cells here) and 500 boxes a class.
- The Waymo head's decode and NMS on one map of 64 x 64 cells, so that
  ``nms_pre_max_size`` 4096 takes every cell and the NMS streams all 32
  chunks of 128 candidates: the same detections as JAX's ``predict`` on
  the same maps.  ``max_per_img`` (4096) is read by neither package.
- The ``_f1`` variant builds the same model config as pp18.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.centerhead import CenterHead as JaxCenterHead
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.core import nms
from pillarnext_tpu_torch.models.centerhead import CenterHead
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils import config as port_config
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from test_torch_port_e2e import randomized_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores, and each torch pool of all cores in each of them
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EXPERIMENTS = Path(__file__).resolve().parent.parent / "pillarnext_tpu/configs/experiments"
PP18 = EXPERIMENTS / "waymo_det_pp18_aspp_iou_car_sp.yaml"
VOXEL18 = EXPERIMENTS / "waymo_det_voxel18_aspp_iou_car.yaml"
NARROWED = {
    "pp18": (PP18, [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0], [
        "model.reader.voxel_size=[0.25,0.25,20.0]",  # 64 x 64 pillars
        "model.reader.num_filters=[16,16]",
        "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]",
        "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32",
        "model.neck.in_channels=32",
        "model.head.in_channels=32",
        "+model.head.share_conv_channel=32",
        "model.dtype=float32",
    ]),
    "voxel18": (VOXEL18, [-8.0, -8.0, -2.0, 8.0, 8.0, 4.0], [
        "model.reader.voxel_size=[0.25,0.25,0.15]",  # 64 x 64 x 40 voxels
        "model.reader.voxel_capacity=4096",
        "model.backbone.ds_num_filters=[8,12,16,16]",
        "+model.backbone.out_channels=16",  # BEV 2 x 16 channels
        "model.neck.in_channels=32",
        "model.head.in_channels=32",
        "+model.head.share_conv_channel=32",
        "model.dtype=float32",
    ]),
}


@pytest.mark.parametrize("family", sorted(NARROWED))
def test_waymo_slice_matches_jax(family):
    path, pc, overrides = NARROWED[family]
    cfg = load_experiment(path, [f"model.reader.pc_range={pc}", *overrides])["model"]
    assert cfg["head"]["rectifier"] == [[0.68], [0.71, 0.65]]
    assert cfg["post_processing"]["nms"]["nms_pre_max_size"] == 4096
    pts, mask = lidar_like_points(2, 3000, pc, seed=0)
    jmodel = jax_builders.build_model(cfg)
    variables = randomized_variables(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    )
    ref, tel = jax.jit(lambda v, p, m: jmodel.apply(
        v, {"points": p, "points_mask": m}, method=jmodel.predict, mutable="telemetry"
    ))(variables, jnp.asarray(pts), jnp.asarray(mask))
    # an overflow would truncate JAX's active set silently
    assert not any(int(np.asarray(leaf).sum()) for path_, leaf in jax.tree_util.tree_flatten_with_path(tel)[0]
                   if "overflow" in jax.tree_util.keystr(path_))
    ref = {k: np.asarray(v) for k, v in ref.items()}

    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    engine = AdaptivePredictor(model)
    got = {k: v.numpy() for k, v in engine.predict(torch.from_numpy(pts), torch.from_numpy(mask)).items()}
    assert engine.repaired == 0

    assert got["box3d_lidar"].shape == ref["box3d_lidar"].shape == (2, 3 * 500, 9)
    assert ref["valid"].sum() >= 8, "vacuous parity: too few detections"
    for i in range(pts.shape[0]):
        o_valid, r_valid = got["valid"][i], ref["valid"][i].astype(bool)
        assert o_valid.sum() == r_valid.sum(), f"sample {i}: {o_valid.sum()} vs {r_valid.sum()}"
        assert set(np.unique(ref["label_preds"][i][r_valid])) == {0, 1, 2}  # both tasks detect
        o_scores, r_scores = got["scores"][i][o_valid], ref["scores"][i][r_valid]
        o_labels, r_labels = got["label_preds"][i][o_valid], ref["label_preds"][i][r_valid]
        o_ord, r_ord = np.lexsort((-o_scores, o_labels)), np.lexsort((-r_scores, r_labels))
        np.testing.assert_array_equal(o_labels[o_ord], r_labels[r_ord])
        np.testing.assert_allclose(o_scores[o_ord], r_scores[r_ord], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(got["box3d_lidar"][i][o_valid][o_ord],
                                   ref["box3d_lidar"][i][r_valid][r_ord],
                                   atol=2e-2, rtol=1e-3, err_msg=f"sample {i} box mismatch")


def _waymo_maps(rng, b, h, w):
    """Head maps of two tasks on an h x w grid: ~99% of the vehicle cells
    and ~58% of the others score above the 0.1 threshold; 20 m boxes on
    0.3 m cells with small yaws, so neighbours overlap beyond every
    threshold and each lane keeps far fewer than its 500 boxes."""
    def task(num_cls, hm_mean):
        return {
            "hm": rng.normal(hm_mean, 1.0, (b, h, w, num_cls)),
            "reg": rng.uniform(0.0, 1.0, (b, h, w, 2)),
            "height": rng.normal(0.0, 0.5, (b, h, w, 1)),
            "dim": rng.normal(np.log(20.0), 0.1, (b, h, w, 3)),
            "rot": np.stack([rng.normal(0.0, 0.1, (b, h, w)), np.ones((b, h, w))], -1),
            "vel": rng.normal(0.0, 1.0, (b, h, w, 2)),
            "iou": rng.normal(0.0, 0.5, (b, h, w, 1)),
        }
    return [{k: v.astype(np.float32) for k, v in task(n, m).items()} for n, m in ((1, 0.0), (2, -2.0))]


def test_waymo_head_predict_streams_4096_candidates_like_jax(monkeypatch):
    cfg = load_experiment(PP18)["model"]
    head_kw = {k: v for k, v in cfg["head"].items() if k != "_target_"}
    test_cfg = cfg["post_processing"]
    assert test_cfg["max_per_img"] == 4096
    maps = _waymo_maps(np.random.default_rng(0), 1, 64, 64)

    jhead = JaxCenterHead(**head_kw)
    want = jax.jit(lambda p: jhead.apply({}, p, test_cfg, method=jhead.predict))(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in maps])
    want = {k: np.asarray(v) for k, v in want.items()}

    chunks = []
    real = nms._chunked_greedy

    def counting(cand, valid, overlap_fn, post_max):
        chunks.append((cand.shape[1], int(valid.sum(1).max())))
        return real(cand, valid, overlap_fn, post_max)

    monkeypatch.setattr(nms, "_chunked_greedy", counting)
    head = CenterHead(**head_kw)
    with torch.no_grad():
        got = head.predict([{k: torch.from_numpy(v) for k, v in d.items()} for d in maps], test_cfg)
    # one NMS call over the three class lanes, 4096 candidates each, and
    # some lane holds valid candidates in the last chunk
    assert len(chunks) == 1 and chunks[0][0] == 4096 and chunks[0][1] > 31 * 128
    valid = got["valid"].numpy()
    assert 50 < valid.sum() < 3 * 500 and (want["valid"].sum(1) < 1500).all()
    np.testing.assert_array_equal(valid, want["valid"])
    np.testing.assert_array_equal(got["label_preds"].numpy(), want["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["box3d_lidar"].numpy()[valid], want["box3d_lidar"][valid],
                               atol=1e-4, rtol=1e-5)


def test_f1_variant_builds_the_pp18_model():
    f1 = port_config.load_experiment(EXPERIMENTS / "waymo_det_pp18_aspp_iou_car_sp_f1.yaml")
    base = port_config.load_experiment(PP18)
    assert f1["model"] == base["model"]
    assert f1["data"]["train_dataset"]["nsweeps"] == 1
