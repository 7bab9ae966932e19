"""Datasets: pickled-infos pipeline, nuScenes and Waymo.

The port's own copy of pillarnext_tpu/data/datasets.py.  Capability parity
with the reference data layer (det3d/datasets/base.py, nuscenes/nusc.py,
waymo/waymo.py) using the same infos pickle schema (nusc_common.py:340-347,
waymo_convert.py:178-183) so data prepared for the reference is directly
consumable.

Pipeline per sample (base.py:64-108), ``get(idx, rng)``: named loading
pipelines -> GT-paste sampling (delete original points inside pasted
boxes, concat crop points) -> augmentations -> target building -> drop raw
annotations.  Every random draw (Waymo's frame dropping, the sampler's
reshuffles and point dropout, each augmentation) comes from ``rng``, the
batch's ``np.random.RandomState`` (data/loader.py), in the order the JAX
package draws them from the global stream.  The pipeline is NumPy end to
end: it runs in forked loader workers, which must not touch the card.
"""

from __future__ import annotations

import itertools
import pickle
from pathlib import Path
from typing import Sequence

import numpy as np

from pillarnext_tpu_torch.core import box_ops


class BaseDataset:
    def __init__(
        self,
        root_path: str,
        info_path: str,
        sampler=None,
        loading_pipelines: Sequence[str] | None = None,
        augmentation: dict | None = None,
        prepare_label: dict | None = None,
        evaluations=None,
        create_database: bool = False,
        use_gt_sampling: bool = True,
    ):
        self._root_path = Path(root_path)
        self._info_path = info_path
        self.loading_pipelines = loading_pipelines
        self.augmentations = augmentation
        self.prepare_label = prepare_label
        self.evaluations = evaluations
        self.create_database = create_database
        self.load_infos()
        # sampler arrives as a partial factory (config _partial_: True,
        # consumed like base.py:36-37)
        self.sampler = sampler() if (use_gt_sampling and sampler is not None) else None

    def __len__(self):
        return len(self.infos)

    def load_infos(self):
        with open(self._root_path / self._info_path, "rb") as f:
            self.infos = pickle.load(f)

    def load_pointcloud(self, res, info, rng):
        raise NotImplementedError

    def load_box3d(self, res, info, rng):
        res["annotations"] = {
            "gt_boxes": np.asarray(info["gt_boxes"], np.float32).copy(),
            "gt_names": np.asarray(info["gt_names"]).reshape(-1).copy(),
        }
        return res

    def get(self, idx: int, rng: np.random.RandomState) -> dict:
        """Sample ``idx`` through the pipeline, drawing from ``rng``."""
        info = self.infos[idx]
        res = {"token": info["token"]}

        if self.loading_pipelines is not None:
            for name in self.loading_pipelines:
                res = getattr(self, name)(res, info, rng)

        if self.sampler is not None:
            sampled = self.sampler.sample_all(
                res["annotations"]["gt_boxes"], res["annotations"]["gt_names"], rng
            )
            if sampled is not None:
                ann = res["annotations"]
                ann["gt_names"] = np.concatenate([ann["gt_names"], sampled["gt_names"]])
                ann["gt_boxes"] = np.concatenate([ann["gt_boxes"], sampled["gt_boxes"]])
                # delete original points inside pasted boxes, then paste crops
                inside = box_ops.points_in_rbbox(
                    res["points"], sampled["gt_boxes"][sampled["gt_masks"]]
                )
                res["points"] = res["points"][~inside.any(axis=-1)]
                res["points"] = np.concatenate([sampled["points"], res["points"]])

        if self.augmentations is not None:
            for aug in self.augmentations.values():
                res = aug(res, rng)

        if self.prepare_label is not None:
            for builder in self.prepare_label.values():
                res = builder(res)

        if "annotations" in res and not self.create_database:
            del res["annotations"]
        return res

    def evaluation(self, detections, output_dir=None):
        raise NotImplementedError


class NuScenesDataset(BaseDataset):
    """10-sweep nuScenes loader (nusc.py:20-121) + CBGS resampling
    (nusc.py:50-70) + evaluation protocol (nusc.py:123-245)."""

    def __init__(
        self,
        info_path: str,
        root_path: str,
        nsweeps: int,
        sampler=None,
        loading_pipelines=None,
        augmentation=None,
        prepare_label=None,
        class_names: Sequence[Sequence[str]] = (),
        resampling: bool = False,
        evaluations=None,
        create_database: bool = False,
        use_gt_sampling: bool = True,
        version: str = "v1.0-trainval",
    ):
        super().__init__(
            root_path,
            info_path,
            sampler,
            loading_pipelines,
            augmentation,
            prepare_label,
            evaluations,
            create_database,
            use_gt_sampling,
        )
        assert nsweeps > 0
        self.nsweeps = nsweeps
        self._class_names = list(itertools.chain(*[list(t) for t in class_names]))
        self.version = version
        if resampling:
            self.cbgs()

    def cbgs(self, seed: int = 0):
        """Class-balanced resampling: duplicate samples of rare classes so
        every class is ~uniformly represented (nusc.py:50-70).

        Seeded with a cross-host-identical constant: every process must
        build the SAME resampled infos list or the loader's
        same-permutation-per-host shard contract (data/loader.py) silently
        skews samples across hosts and desyncs len(train_loader)."""
        cls_infos = {name: [] for name in self._class_names}
        for info in self.infos:
            for name in set(info["gt_names"]):
                if name in cls_infos:
                    cls_infos[name].append(info)
        total = sum(len(v) for v in cls_infos.values())
        if total == 0:
            return
        frac = 1.0 / len(self._class_names)
        rng = np.random.default_rng(seed)
        resampled = []
        for infos in cls_infos.values():
            ratio = frac / (len(infos) / total) if infos else 0.0
            if infos:
                picks = rng.choice(len(infos), int(len(infos) * ratio))
                resampled += [infos[i] for i in picks]
        self.infos = resampled

    def _read_points(self, path: str, num_features: int = 4) -> np.ndarray:
        pts = np.fromfile(self._root_path / path, dtype=np.float32).reshape(-1, 5)
        return pts[:, :num_features]

    @staticmethod
    def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
        near = (np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius)
        return points[~near]

    def load_pointcloud(self, res, info, rng):
        points = self._read_points(info["lidar_path"])
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1), np.float32)]
        for sweep in info["sweeps"]:
            pts = self._read_points(sweep["lidar_path"])
            tm = sweep["transform_matrix"]
            if tm is not None:
                xyz1 = np.concatenate(
                    [pts[:, :3], np.ones((pts.shape[0], 1), pts.dtype)], axis=1
                )
                pts[:, :3] = (xyz1 @ np.asarray(tm, np.float32).T)[:, :3]
            pts = self._remove_close(pts)
            sweep_points.append(pts)
            sweep_times.append(
                np.full((pts.shape[0], 1), sweep["time_lag"], np.float32)
            )
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
        res["points"] = np.hstack([points, times])
        return res

    def evaluation(self, detections, output_dir=None):
        from pillarnext_tpu_torch.data import nuscenes_eval

        return nuscenes_eval.evaluate(
            self, detections, output_dir, class_names=self._class_names
        )


class WaymoDataset(BaseDataset):
    """Waymo loader (waymo.py:16-126): per-frame .bin with NLZ filtering,
    multi-sweep concat via relative pose, random frame dropping."""

    def __init__(
        self,
        info_path: str,
        root_path: str,
        nsweeps: int,
        drop_frames: float = 0.0,
        sampler=None,
        loading_pipelines=None,
        augmentation=None,
        prepare_label=None,
        tasks=(),
        class_names=(),
        evaluations=None,
        create_database: bool = False,
        use_gt_sampling: bool = True,
    ):
        super().__init__(
            root_path,
            info_path,
            sampler,
            loading_pipelines,
            augmentation,
            prepare_label,
            evaluations,
            create_database,
            use_gt_sampling,
        )
        assert nsweeps > 0 and 0 <= drop_frames <= 1
        self.nsweeps = nsweeps
        self.drop_frames = drop_frames
        self.tasks = tasks

    def _read_points(self, token: str, timestamp: float = 0.0) -> np.ndarray:
        pts = np.fromfile(
            self._root_path / "lidar_point" / f"{token}.bin", dtype=np.float32
        ).reshape(-1, 6)
        # columns: x y z intensity elongation nlz_flag; keep xyzi of
        # points outside no-label zones (flag == -1), waymo.py:41-47
        pts = pts[pts[:, -1] == -1, :4]
        times = np.full((pts.shape[0], 1), timestamp, np.float32)
        return np.concatenate([pts, times], axis=1)

    def load_pointcloud(self, res, info, rng):
        points = self._read_points(info["token"])
        points_list = [points]
        if self.nsweeps > 1:
            for sweep in info["sweeps"][: self.nsweeps - 1]:
                if self.drop_frames > 0 and rng.uniform() < self.drop_frames:
                    continue
                prev = self._read_points(sweep["token"], timestamp=sweep["timestamp"])
                rel_pose = np.linalg.inv(info["pose"]) @ sweep["pose"]
                xyz1 = np.concatenate(
                    [prev[:, :3], np.ones((prev.shape[0], 1), prev.dtype)], axis=1
                )
                prev[:, :3] = (xyz1 @ rel_pose.T.astype(np.float32))[:, :3]
                points_list.append(prev)
        res["points"] = np.concatenate(points_list, axis=0).astype(np.float32)
        return res

    def load_box3d(self, res, info, rng):
        objects = info["objects"]
        num_pts = np.array([o["num_points"] for o in objects])
        keep = (num_pts > 0).reshape(-1)
        boxes = np.array([o["box"] for o in objects], np.float32).reshape(-1, 9)
        names = np.array([o["label"] for o in objects])
        res["annotations"] = {
            "gt_boxes": boxes[keep].copy(),
            "gt_names": names[keep].copy(),
        }
        return res

    def evaluation(self, detections, output_dir=None):
        from pillarnext_tpu_torch.data import waymo_eval

        return waymo_eval.export_detections(detections, output_dir)
