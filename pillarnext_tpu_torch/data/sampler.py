"""GT-paste database sampling (host side).

The port's own copy of pillarnext_tpu/data/sampler.py.  Capability parity
with the reference DataBaseSamplerV2 / BatchSampler / DBFilterByMinNumPoint
(det3d/datasets/pipelines/sample_ops.py): per-class quotas, shuffled cyclic
crop sampling, BEV rotated-box collision rejection (native C++ library),
crop loading + recentering, optional point dropout.

Randomness is explicit: each class's first shuffle draws from one
``np.random.RandomState(INIT_SEED)`` shared by the classes in dict order,
and every later draw (a cursor's reshuffle, point dropout) from the
batch's ``rng`` (data/loader.py).  The JAX package draws the same values
in the same order from the global stream (its first shuffles from the
stream as it stands when the dataset is built: seed it with
``np.random.seed(INIT_SEED)`` to compare).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Sequence

import numpy as np

from pillarnext_tpu_torch.core import box_ops

INIT_SEED = 0  # the cursors' first shuffles: the same crop order in every process


class BatchSampler:
    """Shuffled cyclic index sampler over one class's crop list
    (sample_ops.py:10-42).  ``rng`` draws the first shuffle."""

    def __init__(self, sampled_list, rng: np.random.RandomState, shuffle: bool = True):
        self._list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._shuffle = shuffle
        if shuffle:
            rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num: int, rng: np.random.RandomState):
        n = len(self._list)
        if n == 0:
            return []
        if self._idx + num >= n:
            picked = self._indices[self._idx :].copy()
            if self._shuffle:
                rng.shuffle(self._indices)
            self._idx = 0
        else:
            picked = self._indices[self._idx : self._idx + num]
            self._idx += num
        return [self._list[i] for i in picked]


class DBFilterByMinNumPoint:
    """Prune crops with too few points (sample_ops.py:55-67)."""

    def __init__(self, min_gt_point_dict: dict, logger=None):
        self.min_gt_point_dict = min_gt_point_dict

    def __call__(self, db_infos: dict) -> dict:
        for name, min_num in self.min_gt_point_dict.items():
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name] if info["num_points_in_gt"] >= min_num
                ]
        return db_infos


class DataBaseSampler:
    """Paste-augmentation sampler (sample_ops.py:70-235).

    ``sample_all(gt_boxes, gt_names, rng)`` returns crops to paste: names,
    9-dim boxes, recentered points, and a keep mask — or None if nothing
    sampled.
    """

    def __init__(
        self,
        root_path: str,
        dbinfo_path: str,
        groups: Sequence[dict],
        db_prepor: dict | None,
        rate: float,
        gt_drop_percentage: float,
        gt_drop_max_keep_points: int,
        point_dim: int,
    ):
        self.root_path = Path(root_path)
        with open(self.root_path / dbinfo_path, "rb") as f:
            db_infos = pickle.load(f)
        if db_prepor is not None:
            for prep in db_prepor.values():
                db_infos = prep(db_infos)

        self.rate = rate
        self.point_dim = point_dim
        self.gt_drop_rate = gt_drop_percentage
        self.gt_drop_max_keep = gt_drop_max_keep_points

        self.sample_classes: list[str] = []
        self.sample_max_nums: list[int] = []
        for group in groups:
            self.sample_classes += list(group.keys())
            self.sample_max_nums += list(group.values())

        init_rng = np.random.RandomState(INIT_SEED)
        self.samplers = {
            name: BatchSampler(infos, init_rng) for name, infos in db_infos.items()
        }

    def _sample_class(self, name: str, num: int, avoid_boxes: np.ndarray, rng):
        """Draw crops, reject BEV collisions against existing + accepted
        boxes (sample_ops.py:202-235)."""
        if name not in self.samplers:
            return []
        candidates = self.samplers[name].sample(num, rng)
        if not candidates:
            return []
        num_gt = avoid_boxes.shape[0]
        cand_boxes = np.stack([c["box3d_lidar"] for c in candidates])
        all_boxes = np.concatenate([avoid_boxes, cand_boxes], axis=0)
        corners = box_ops.center_to_corner_box2d(all_boxes[:, [0, 1, 3, 4, -1]])
        coll = box_ops.box_collision_test(corners, corners)
        np.fill_diagonal(coll, False)

        valid = []
        for i in range(num_gt, num_gt + len(candidates)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(candidates[i - num_gt])
        return valid

    def sample_all(self, gt_boxes: np.ndarray, gt_names: np.ndarray, rng: np.random.RandomState):
        sampled = []
        sampled_boxes = []
        avoid = gt_boxes
        for name, quota in zip(self.sample_classes, self.sample_max_nums):
            want = int(np.round(self.rate * (quota - (gt_names == name).sum())))
            if want <= 0:
                continue
            picked = self._sample_class(name, want, avoid, rng)
            if not picked:
                continue
            boxes = np.stack([p["box3d_lidar"] for p in picked])
            sampled += picked
            sampled_boxes.append(boxes)
            avoid = np.concatenate([avoid, boxes], axis=0)

        if not sampled:
            return None

        boxes = np.concatenate(sampled_boxes, axis=0).astype(np.float32)
        points_list = []
        for info in sampled:
            pts = np.fromfile(
                str(self.root_path / info["path"]), dtype=np.float32
            ).reshape(-1, self.point_dim)
            pts = pts.copy()
            pts[:, :3] += info["box3d_lidar"][:3]
            points_list.append(pts)

        if 0 < self.gt_drop_rate < 1:
            counts = np.zeros(len(points_list))
            for i, pts in enumerate(points_list):
                keep = rng.uniform(size=len(pts)) >= self.gt_drop_rate
                points_list[i] = pts[keep]
                counts[i] = keep.sum()
            keep_mask = counts >= self.gt_drop_max_keep
        else:
            keep_mask = np.ones(len(sampled), dtype=bool)

        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "gt_boxes": boxes,
            "points": np.concatenate(points_list, axis=0).astype(np.float32),
            "gt_masks": keep_mask,
        }
