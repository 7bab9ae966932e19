"""The port's flagship slice as a whole vs the JAX package, on the CPU.

The real flagship experiment YAML, narrowed (+-8 m, 0.25 m pillars, narrow
widths, float32), goes through JAX ``build_model`` + ``predict`` and through
the port's ``build_model`` + ``AdaptivePredictor``, with the JAX weights
carried across by ``pillarnext_tpu_torch.utils.weights``.  Bars are those of
tests/test_detection_parity.py:206-211.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.weights import load_jax_variables

FLAGSHIP = (
    Path(__file__).resolve().parent.parent
    / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
)
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
OVERRIDES = [
    f"model.reader.pc_range={PC}",
    "model.reader.voxel_size=[0.25,0.25,8.0]",
    "model.reader.num_filters=[16,16]",
    "model.reader.pillar_capacity=4096",
    "model.backbone.ds_num_filters=[16,32,32,32]",
    "model.backbone.num_input_features=16",
    "+model.backbone.out_channels=32",
    "model.neck.in_channels=32",
    "model.head.in_channels=32",
    "+model.head.share_conv_channel=32",
    "model.dtype=float32",
]


def small_flagship_cfg():
    return load_experiment(FLAGSHIP, OVERRIDES)["model"]


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


def test_flagship_slice_matches_jax():
    cfg = small_flagship_cfg()
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    jmodel = jax_builders.build_model(cfg)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
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
