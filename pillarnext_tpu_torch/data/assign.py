"""CenterPoint target assignment (host side, NumPy).

The port's own copy of pillarnext_tpu/data/assign.py (same arrays for the
same input): per task group, per-class
gaussian heatmaps (CornerNet radius, min_overlap=gaussian_overlap, floor
min_radius), flattened center indices ``ind = y*W + x``, validity ``mask``,
per-object class ``cat``, the 10-dim regression target
``[dx, dy, z, log(l), log(w), log(h), vx, vy, sin(yaw), cos(yaw)]``, and the
7-dim ``gt_boxes`` used by the IoU losses.  All outputs are fixed-size
(max_objs) — already static-shape friendly.

Heatmaps are produced in (H, W, C) channel-last layout for the NHWC model.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pillarnext_tpu_torch.core.gaussian import draw_gaussian, gaussian_radius


class AssignLabel:
    def __init__(
        self,
        tasks: Sequence[Sequence[str]],
        gaussian_overlap: float,
        max_objs: int,
        min_radius: int,
        pc_range: Sequence[float],
        voxel_size: Sequence[float],
        out_size_factor: Sequence[int],
    ):
        self.tasks = [list(t) for t in tasks]
        self.gaussian_overlap = gaussian_overlap
        self.max_objs = max_objs
        self.min_radius = min_radius
        self.pc_range = np.asarray(pc_range, np.float64)
        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.out_size_factor = np.asarray(out_size_factor, np.int64)
        self.class_to_task = {
            name: (ti, ci)
            for ti, task in enumerate(self.tasks)
            for ci, name in enumerate(task)
        }
        grid = np.round((self.pc_range[3:] - self.pc_range[:3]) / self.voxel_size)
        self.grid_size = grid.astype(np.int64)  # (x, y, z)

    def feature_map_size(self, task_id: int) -> tuple[int, int]:
        """(W, H) of the label grid for one task group."""
        f = int(self.out_size_factor[task_id])
        return int(self.grid_size[0]) // f, int(self.grid_size[1]) // f

    def __call__(self, res: dict) -> dict:
        gt = res["annotations"]
        m = self.max_objs

        hms, annos, inds, masks, cats, gt7s = [], [], [], [], [], []
        for ti, task in enumerate(self.tasks):
            w, h = self.feature_map_size(ti)
            hms.append(np.zeros((h, w, len(task)), np.float32))
            annos.append(np.zeros((m, 10), np.float32))
            inds.append(np.zeros((m,), np.int64))
            masks.append(np.zeros((m,), np.uint8))
            cats.append(np.zeros((m,), np.int64))
            gt7s.append(np.zeros((m, 7), np.float32))

        counts = np.zeros(len(self.tasks), np.int64)
        boxes = gt["gt_boxes"]
        names = gt["gt_names"]
        for k in range(len(names)):
            loc = self.class_to_task.get(names[k])
            if loc is None:
                continue
            ti, ci = loc
            box = boxes[k]
            f = float(self.out_size_factor[ti])
            size_x = box[3] / self.voxel_size[0] / f
            size_y = box[4] / self.voxel_size[1] / f
            if size_x <= 0 or size_y <= 0 or counts[ti] >= m:
                continue

            radius = gaussian_radius((size_y, size_x), min_overlap=self.gaussian_overlap)
            radius = max(self.min_radius, int(radius))

            cx = (box[0] - self.pc_range[0]) / self.voxel_size[0] / f
            cy = (box[1] - self.pc_range[1]) / self.voxel_size[1] / f
            ix, iy = int(cx), int(cy)
            h, w = hms[ti].shape[:2]
            if not (0 <= ix < w and 0 <= iy < h):
                continue

            draw_gaussian(hms[ti][:, :, ci], (ix, iy), radius)

            j = counts[ti]
            cats[ti][j] = ci
            inds[ti][j] = iy * w + ix
            masks[ti][j] = 1
            vx, vy = box[6], box[7]
            yaw = box[8]
            annos[ti][j] = [
                cx - ix,
                cy - iy,
                box[2],
                np.log(box[3]),
                np.log(box[4]),
                np.log(box[5]),
                vx,
                vy,
                np.sin(yaw),
                np.cos(yaw),
            ]
            gt7s[ti][j] = [box[0], box[1], box[2], box[3], box[4], box[5], yaw]
            counts[ti] += 1

        res.update(
            {"hm": hms, "anno_box": annos, "ind": inds, "mask": masks, "cat": cats,
             "gt_boxes": gt7s}
        )
        return res
