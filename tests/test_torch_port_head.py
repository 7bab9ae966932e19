"""The port's top-k, rotated IoU, NMS and CenterHead vs the JAX package (CPU).

- ``exact_top_k``: identical values and indices to ``jax.lax.top_k`` on a
  lane full of ties (ascending index among equal scores).
- ``boxes_iou_bev``: within 1e-5 of ``jax_box_ops.boxes_iou_bev``.
- ``rotated_nms``: identical kept indices on a suppression chain longer
  than one 128-candidate chunk, and on random scenes, batched over lanes.
- ``CenterHead``: dense maps within 1e-3; ``predict`` on the same maps gives
  the same detections.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pillarnext_tpu.core import jax_box_ops
from pillarnext_tpu.core import nms as jax_nms
from pillarnext_tpu.models.centerhead import CenterHead as JaxCenterHead
from pillarnext_tpu.utils import torch_import as ti
from pillarnext_tpu_torch.core import nms, torch_box_ops
from pillarnext_tpu_torch.models.centerhead import CenterHead
from pillarnext_tpu_torch.ops.topk import exact_top_k
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_exact_top_k_tie_order():
    rng = np.random.default_rng(0)
    scores = rng.choice(np.float32([0.1, 0.25, 0.5, -1e9]), size=(3, 4000)).astype(np.float32)
    scores[1, :] = 0.5  # an all-tied lane
    vals, idx = exact_top_k(torch.from_numpy(scores), 700)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 700)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def _random_boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.normal(0, 0.5, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_boxes_iou_bev_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _random_boxes(rng, 60), _random_boxes(rng, 70)
    b[:5] = a[:5]  # identical boxes: coincident boundaries
    got = torch_box_ops.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_box_ops.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    batched = torch_box_ops.boxes_iou_bev(torch.from_numpy(a)[None], torch.from_numpy(b)[None])
    np.testing.assert_array_equal(batched[0].numpy(), got)


def test_rotated_nms_matches_jax():
    rng = np.random.default_rng(2)
    # lane 0: a 300-box chain along x, each box overlapping only its
    # neighbours, scores descending: greedy keeps every other box, and the
    # chain crosses three 128-candidate chunks
    chain = np.zeros((300, 7), np.float32)
    chain[:, 0] = np.arange(300) * 0.6
    chain[:, 3:6] = 1.0
    chain_scores = np.linspace(1.0, 0.5, 300).astype(np.float32)
    # lane 1: a random cluttered scene with invalid (NEG_INF) rows
    rand = _random_boxes(rng, 300, spread=5.0)
    rand_scores = rng.uniform(0, 1, 300).astype(np.float32)
    rand_scores[rng.random(300) < 0.2] = nms.NEG_INF
    boxes = np.stack([chain, rand])
    scores = np.stack([chain_scores, rand_scores])
    thresh = np.float32([0.1, 0.2])

    sel, valid = nms.rotated_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(thresh), 280, 160
    )
    for lane in range(2):
        js, jv = jax_nms.rotated_nms(
            jnp.asarray(boxes[lane]), jnp.asarray(scores[lane]), float(thresh[lane]), 280, 160
        )
        np.testing.assert_array_equal(valid[lane].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(sel[lane].numpy(), np.asarray(js))
    assert int(valid[0].sum()) == 140  # 280 candidates, every other kept


TASKS = [["car"], ["truck", "bus"]]
COMMON = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2), "vel": (2, 2)}
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
TEST_CFG = {
    "post_center_limit_range": [-10.0, -10.0, -6.0, 10.0, 10.0, 4.0],
    "nms": {"nms_pre_max_size": 200, "nms_post_max_size": 20,
            "nms_iou_threshold": [[0.2], [0.2, 0.25]]},
    "score_threshold": 0.1,
    "pc_range": PC,
    "voxel_size": [0.25, 0.25, 8.0],
    "out_size_factor": [2, 2],
    "nms_type": "iou3d",
}
HEAD_KW = dict(
    in_channels=16, tasks=TASKS, weight=0.25, code_weights=[1.0] * 10,
    common_heads=COMMON, strides=[2, 2], share_conv_channel=16,
    rectifier=[[0.5], [0.5, 0.3]], voxel_size=[0.25, 0.25, 8.0], pc_range=PC,
    out_size_factor=[2, 2],
)


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_center_head_maps_and_predict_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    jhead = JaxCenterHead(**HEAD_KW)
    variables = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    jmaps = jax.jit(lambda v, a: jhead.apply(v, a))(variables, jnp.asarray(x))

    sd = {}
    ti._export_neck_head(
        sd, {"neck": _FAKE_NECK, "head": variables["params"]},
        {"neck": _FAKE_NECK_STATS, "head": variables["batch_stats"]}, TASKS, COMMON,
    )
    sd = {k[len("head."):]: torch.from_numpy(np.array(v, np.float32))
          for k, v in sd.items() if k.startswith("head.")}
    head = CenterHead(**HEAD_KW)
    head.load_state_dict(sd, strict=True)
    head.eval()
    with torch.no_grad():
        maps = head(torch.from_numpy(x))
    for t, (jm, m) in enumerate(zip(jmaps, maps)):
        assert set(jm) == set(m)
        for name in jm:
            np.testing.assert_allclose(
                m[name].numpy(), np.asarray(jm[name]), atol=1e-3, rtol=1e-3,
                err_msg=f"task {t} {name}",
            )

    # predict on the same (JAX) maps
    want = jax.jit(lambda v, p: jhead.apply(v, p, TEST_CFG, method=jhead.predict))(variables, jmaps)
    with torch.no_grad():
        got = head.predict(
            [{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in jmaps], TEST_CFG
        )
    assert int(np.asarray(want["valid"]).sum()) >= 8
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["label_preds"].numpy(), np.asarray(want["label_preds"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-5, rtol=1e-5)
    v = got["valid"].numpy()
    np.testing.assert_allclose(
        got["box3d_lidar"].numpy()[v], np.asarray(want["box3d_lidar"])[v], atol=1e-4, rtol=1e-5
    )


# the neck half of the shared export is not under test here
_C = 16
_FAKE_NECK = {
    "BasicBlock_0": {f"ConvBlock_{j}": {"Conv_0": {"kernel": np.zeros((3, 3, _C, _C))},
                                        "BatchNorm_0": {"scale": np.ones(_C), "bias": np.zeros(_C)}}
                     for j in range(2)},
    "Conv_0": {"kernel": np.zeros((1, 1, _C, _C))},
    "shared_dilated_kernel": np.zeros((3, 3, _C, _C)),
    "ConvBlock_0": {"Conv_0": {"kernel": np.zeros((1, 1, 6 * _C, _C))},
                    "BatchNorm_0": {"scale": np.ones(_C), "bias": np.zeros(_C)}},
}
_FAKE_NECK_STATS = {
    "BasicBlock_0": {f"ConvBlock_{j}": {"BatchNorm_0": {"mean": np.zeros(_C), "var": np.ones(_C)}}
                     for j in range(2)},
    "ConvBlock_0": {"BatchNorm_0": {"mean": np.zeros(_C), "var": np.ones(_C)}},
}
