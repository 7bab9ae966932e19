"""The port's post-processing options vs the JAX package (CPU).

- ``circle_nms`` and ``axis_aligned_nms``: the kept indices and their
  validity equal JAX's (pillarnext_tpu/core/nms.py) lane by lane, on the
  cases of tests/test_rotated_iou.py and on random lanes with tied scores
  (JAX's tie order: ascending index), batched over lanes.
- ``predict`` with ``nms_type: circle`` (the lane's ``nms_iou_threshold``
  its radius) and with ``approx_topk: true`` on the same maps as JAX's
  predict: the same detections, bit for bit in labels and validity,
  scores within 1e-6, boxes within 1e-5.
- An ``nms_type`` that is neither ``iou3d`` nor ``circle`` raises at build
  (JAX runs rotated NMS for any such name, the reference's ``circle_nms``
  included).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.core import nms as jax_nms
from pillarnext_tpu.models.centerhead import CenterHead as JaxCenterHead
from pillarnext_tpu_torch.core import nms
from pillarnext_tpu_torch.models.detector import SingleStageDetector
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES
from tests.test_torch_port_head_options import HEAD_KW, TEST_CFG, _features, _numpy, jax_variables, one_torch_thread, \
    port_head, reference_state_dict  # noqa: F401 (one_torch_thread: an autouse fixture)


def _lanes(kind, seed=0, lanes=3, n=300):
    """Random (L, N, D) rows with tied scores and NEG_INF rows."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((lanes, n, 7), np.float32)
    rows[..., :2] = rng.uniform(-6.0, 6.0, (lanes, n, 2))
    rows[..., 3:6] = rng.uniform(0.5, 3.0, (lanes, n, 3))
    rows[..., 6] = rng.uniform(-np.pi, np.pi, (lanes, n))
    scores = rng.choice(np.float32([0.2, 0.4, 0.6, 0.8]), (lanes, n)).astype(np.float32)
    scores[rng.random((lanes, n)) < 0.15] = nms.NEG_INF
    thresh = np.float32([0.5, 1.0, 2.0]) if kind == "circle" else np.float32([0.1, 0.3, 0.5])
    return rows, scores, thresh


CASES = {
    # tests/test_rotated_iou.py: yaw-blind suppression, far boxes kept
    "axis_aligned": (np.array([[[0, 0, 0, 4, 0.5, 1, 0.0], [0, 0, 0, 4, 0.5, 1, np.pi / 2],
                                [9, 9, 0, 2, 2, 1, 1.2], [9.2, 9, 0, 2, 2, 1, 0.0]]], np.float32),
                     np.float32([[0.9, 0.8, 0.7, 0.6]]), np.float32([0.5]), [0, 2]),
    "circle": (np.array([[[0, 0], [0.5, 0], [5, 5]]], np.float32), np.float32([[0.9, 0.8, 0.85]]),
               np.float32([1.0]), [0, 2]),
}


@pytest.mark.parametrize("kind", ["axis_aligned", "circle"])
def test_nms_variants_match_jax(kind):
    port_fn = {"axis_aligned": nms.axis_aligned_nms, "circle": nms.circle_nms}[kind]
    jax_fn = {"axis_aligned": jax_nms.axis_aligned_nms, "circle": jax_nms.circle_nms}[kind]
    rows, scores, thresh, kept = CASES[kind]
    sel, valid = port_fn(torch.from_numpy(rows), torch.from_numpy(scores), torch.from_numpy(thresh), 4, 4)
    assert sorted(sel[0][valid[0]].tolist()) == kept
    rows, scores, thresh = _lanes(kind)
    if kind == "circle":
        rows = rows[..., :2]
    for pre, post in ((280, 160), (300, 40)):
        sel, valid = port_fn(torch.from_numpy(rows), torch.from_numpy(scores), torch.from_numpy(thresh),
                             pre, post)
        for lane in range(rows.shape[0]):
            js, jv = jax_fn(jnp.asarray(rows[lane]), jnp.asarray(scores[lane]), float(thresh[lane]), pre, post)
            np.testing.assert_array_equal(valid[lane].numpy(), np.asarray(jv), err_msg=f"lane {lane}")
            np.testing.assert_array_equal(sel[lane].numpy(), np.asarray(js), err_msg=f"lane {lane}")
        assert int(valid.sum()) > 20


@pytest.mark.parametrize("option", [{"nms_type": "circle"}, {"approx_topk": True}])
def test_predict_options_match_jax(option):
    sd = reference_state_dict()
    variables = jax_variables(sd)
    jhead = JaxCenterHead(**HEAD_KW)
    x = jnp.asarray(_features())
    cfg = dict(TEST_CFG, **option)
    if "nms_type" in option:  # radii in metres
        cfg["nms"] = dict(cfg["nms"], nms_iou_threshold=[[1.0], [0.8, 1.2], [0.5, 0.5, 0.5]])
    jmaps = jax.jit(jhead.apply)(variables, x)
    want = _numpy(jax.jit(lambda v, p: jhead.apply(v, p, cfg, method=jhead.predict))(variables, jmaps))
    head = port_head(sd).eval()
    with torch.no_grad():
        got = _numpy(head.predict([{k: torch.tensor(np.asarray(v)) for k, v in d.items()} for d in jmaps], cfg))
    assert int(want["valid"].sum()) >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6, rtol=0)
    v = want["valid"].astype(bool)
    np.testing.assert_allclose(got["box3d_lidar"][v], want["box3d_lidar"][v], atol=1e-5, rtol=1e-6)


def test_unknown_nms_type_raises():
    with pytest.raises(ValueError, match="nms_type"):
        SingleStageDetector(None, post_processing={"nms_type": "circle_nms"})
    for override in ("model.post_processing.nms_type=circle", "model.post_processing.approx_topk=true"):
        model = build_model(load_experiment(FLAGSHIP, OVERRIDES + [override])["model"], device="cpu")
        assert model.post_processing[override.split(".")[-1].split("=")[0]] in ("circle", True)
