"""The port's voxel18 serving slice as a whole vs the JAX package, on the CPU.

The real voxel18 experiment YAML (nusc_det_voxel18_aspp_iou_sp), narrowed
to +-8 m in x/y at 0.25 m (the config's 40 levels of 0.2 m in z, so the
backbone ends at depth 2 as at full size), narrow widths, float32, goes
through JAX ``build_model`` + ``predict`` and through the port's
``build_model`` + ``AdaptivePredictor``, with the JAX weights carried
across by ``pillarnext_tpu_torch.utils.weights`` (``export_voxelnext``).
Bars: those of tests/test_torch_port_e2e.py (scores 2e-3 / 1e-3, boxes
2e-2 / 1e-3), the same detection set.

Also the port's serving of this slice: a bucket whose reader table holds
every voxel but whose stage-1 table overflows is repaired at the largest
bucket and gives that bucket's detections.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

VOXEL18 = (
    Path(__file__).resolve().parent.parent
    / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
)
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
OVERRIDES = [
    f"model.reader.pc_range={PC}",
    "model.reader.voxel_size=[0.25,0.25,0.2]",  # grid 64 x 64 x 40
    "model.reader.voxel_capacity=4096",
    "model.backbone.ds_num_filters=[8,12,16,16]",
    "model.backbone.out_channels=16",  # BEV 2 x 16 channels
    "model.neck.in_channels=32",
    "model.head.in_channels=32",
    "+model.head.share_conv_channel=32",
    "model.dtype=float32",
]


def small_voxel18_cfg():
    return load_experiment(VOXEL18, OVERRIDES)["model"]


def randomized_variables(variables, seed=0):
    """Numpy copy of the JAX variables with non-trivial BN affine and
    statistics (the init leaves BN at identity)."""
    rng = np.random.default_rng(seed)

    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, kind)
                continue
            a = np.array(v, np.float32)
            if k == "scale":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "bias" and kind == "params" and a.ndim == 1 and not np.any(a):
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            elif k == "mean":
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            out[k] = a
        return out

    return {kind: walk(jax.tree.map(np.asarray, variables[kind]), kind)
            for kind in ("params", "batch_stats")}


def test_voxel18_slice_matches_jax():
    cfg = small_voxel18_cfg()
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    jmodel = jax_builders.build_model(cfg)
    variables = randomized_variables(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    )
    ref = jax.jit(
        lambda v, p, m: jmodel.apply(v, {"points": p, "points_mask": m}, method=jmodel.predict)
    )(variables, jnp.asarray(pts), jnp.asarray(mask))
    ref = {k: np.asarray(v) for k, v in ref.items()}

    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    got = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))
    got = {k: v.numpy() for k, v in got.items()}

    assert got["box3d_lidar"].shape == ref["box3d_lidar"].shape == (2, 10 * 83, 9)
    assert ref["valid"].sum() >= 8, "vacuous parity: too few detections"
    for i in range(pts.shape[0]):
        o_valid, r_valid = got["valid"][i], ref["valid"][i].astype(bool)
        assert o_valid.sum() == r_valid.sum(), f"sample {i}: {o_valid.sum()} vs {r_valid.sum()}"
        o_scores, r_scores = got["scores"][i][o_valid], ref["scores"][i][r_valid]
        o_labels, r_labels = got["label_preds"][i][o_valid], ref["label_preds"][i][r_valid]
        o_ord = np.lexsort((-o_scores, o_labels))
        r_ord = np.lexsort((-r_scores, r_labels))
        np.testing.assert_array_equal(o_labels[o_ord], r_labels[r_ord])
        np.testing.assert_allclose(o_scores[o_ord], r_scores[r_ord], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(
            got["box3d_lidar"][i][o_valid][o_ord],
            ref["box3d_lidar"][i][r_valid][r_ord],
            atol=2e-2, rtol=1e-3, err_msg=f"sample {i} box mismatch",
        )


def _scattered_points(n, seed):
    """Points spread through the volume, z uniform: each occupied voxel
    dilates into several stage-1 sites, unlike ground-heavy LiDAR."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((1, n, 5), np.float32)
    pts[..., :2] = rng.uniform(-7.9, 7.9, (1, n, 2))
    pts[..., 2] = rng.uniform(-4.9, 2.9, (1, n))
    pts[..., 3:] = rng.uniform(0, 1, (1, n, 2))
    return torch.from_numpy(pts), torch.ones((1, n), dtype=torch.bool)


def test_adaptive_predictor_repairs_a_stage_overflow():
    cfg = small_voxel18_cfg()
    cfg["reader"]["voxel_capacity"] = 16384
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    points, mask = _scattered_points(3000, seed=1)
    small = 4096
    tel = {}
    with torch.inference_mode():
        model.predict(points, mask, capacity=small, telemetry=tel)
        want = model.predict(points, mask, capacity=16384, telemetry=(big := {}))
    tel = {k: int(v) for k, v in tel.items()}
    # the reader's table holds every voxel; stage 1 outgrows 1.45 x 4096
    assert tel["voxel_overflow"] == 0 and tel["voxel_active"] <= small
    assert tel["stage1_overflow"] > 0, tel
    assert all(int(v) == 0 for k, v in big.items() if "overflow" in k), big

    assert AdaptivePredictor(model).buckets[-1] == model.reader.voxel_capacity == 16384
    engine = AdaptivePredictor(model, buckets=(small, 16384), track_capacity=False)
    got = engine.predict(points, mask)
    assert engine.repaired == 1 and engine.level == 1
    for key in ("box3d_lidar", "scores", "label_preds", "valid"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_build_model_voxel18_defaults_to_the_card_and_refuses_training():
    """Eval and training both default to the card (and raise without
    one); on the CPU, training builds the sparse voxel reader and the 3-D
    backbone in train mode."""
    cfg = load_experiment(VOXEL18)["model"]
    if not torch.cuda.is_available():
        for train in (False, True):
            with pytest.raises(RuntimeError, match="cuda"):
                build_model(cfg, train=train)
    model = build_model(small_voxel18_cfg(), device="cpu", train=True)
    assert model.training and model.backbone.training
    assert model.reader.output == "sparse"
    assert type(model.backbone).__name__ == "SparseResNet3D"
