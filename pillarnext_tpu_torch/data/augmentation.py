"""Global point/box augmentations (host side, NumPy).

The port's own copy of pillarnext_tpu/data/augmentation.py.  Semantics
parity with det3d/datasets/pipelines/augmentation.py: each transform guards
NaN velocity slots (GT-paste crops carry NaN vx/vy) by zeroing before the
geometric op and restoring NaN after.

Each transform takes the pipeline ``res`` dict with 'points' (N, D) and
optional res['annotations']['gt_boxes'] (M, 9), and the batch's
``np.random.RandomState``; it returns ``res``.  The JAX package draws the
same values in the same order from the global stream, which its loader
seeds as the port's loader seeds ``rng`` (data/loader.py); the port never
touches the global stream.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pillarnext_tpu_torch.core import box_ops


def _transform_boxes(res: dict, fn) -> None:
    ann = res.get("annotations")
    if not ann or "gt_boxes" not in ann:
        return
    boxes = ann["gt_boxes"]
    nan_mask = np.isnan(boxes)
    boxes[nan_mask] = 0
    boxes = fn(boxes)
    boxes[nan_mask] = np.nan
    ann["gt_boxes"] = boxes


class Flip:
    """Random per-axis mirror (augmentation.py:5-37).  flip_prob =
    (p_x_axis, p_y_axis): 'x' mirrors y -> -y, 'y' mirrors x -> -x."""

    def __init__(self, flip_prob: Sequence[float]):
        assert 0 <= flip_prob[0] < 1 and 0 <= flip_prob[1] < 1
        self.flip_prob = flip_prob

    def __call__(self, res: dict, rng: np.random.RandomState) -> dict:
        if self.flip_prob[0] > 0 and rng.uniform() < self.flip_prob[0]:
            res["points"][:, 1] = -res["points"][:, 1]
            _transform_boxes(res, lambda b: box_ops.flip(b, axis="x"))
        if self.flip_prob[1] > 0 and rng.uniform() < self.flip_prob[1]:
            res["points"][:, 0] = -res["points"][:, 0]
            _transform_boxes(res, lambda b: box_ops.flip(b, axis="y"))
        return res


class Scaling:
    """Uniform global scale (augmentation.py:40-53)."""

    def __init__(self, scale: Sequence[float]):
        self.min_scale, self.max_scale = scale

    def __call__(self, res: dict, rng: np.random.RandomState) -> dict:
        s = rng.uniform(self.min_scale, self.max_scale)
        res["points"][:, :3] *= s
        _transform_boxes(res, lambda b: box_ops.scaling(b, s))
        return res


class Rotation:
    """Global yaw rotation (augmentation.py:56-72)."""

    def __init__(self, rotation: Sequence[float]):
        self.rotation = rotation

    def __call__(self, res: dict, rng: np.random.RandomState) -> dict:
        angle = rng.uniform(self.rotation[0], self.rotation[1])
        res["points"][:, :3] = box_ops.yaw_rotation(res["points"][:, :3], angle)
        _transform_boxes(res, lambda b: box_ops.rotate(b, angle))
        return res


class Translation:
    """Gaussian global offset (augmentation.py:75-88).  Matches the
    reference's single scalar noise draw applied to all three axes."""

    def __init__(self, noise: float):
        self.noise = noise

    def __call__(self, res: dict, rng: np.random.RandomState) -> dict:
        offset = rng.normal(0, self.noise, 1)
        res["points"][:, :3] += offset
        _transform_boxes(res, lambda b: box_ops.translate(b, offset))
        return res
