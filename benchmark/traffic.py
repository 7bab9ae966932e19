"""The benchmark's traffic: labelled LiDAR-like scenes from a seed, their
CenterPoint targets, collated to the configs' fixed point slots.

A frozen copy of the scene generator and the target assignment the port
uses (``utils/synth.py``, ``data/assign.py``, ``core/gaussian.py``,
``data/collate.py``), so that no later change to the program moves the
yardstick.  A traffic file (``benchmark/traffic/<mix>.json``) gives the
mode, the batch, the points a frame, the range of planted objects, the
batches in the pool and the batches the correctness check samples.  One
seed gives the same pool; every seed draws the same sizes.
"""

from __future__ import annotations

import numpy as np

# class -> ((l, w, h), z centre, moving): nuScenes-plausible box sizes
CLASS_SPECS = {
    "car": ((4.5, 1.9, 1.6), -1.0, True),
    "truck": ((6.9, 2.5, 2.8), -0.4, True),
    "construction_vehicle": ((6.0, 2.8, 3.2), -0.2, False),
    "bus": ((11.0, 2.9, 3.4), -0.3, True),
    "trailer": ((12.3, 2.9, 3.8), -0.2, False),
    "barrier": ((2.0, 0.6, 1.0), -1.3, False),
    "motorcycle": ((2.1, 0.8, 1.4), -1.1, True),
    "bicycle": ((1.7, 0.6, 1.3), -1.1, True),
    "pedestrian": ((0.7, 0.7, 1.7), -0.9, True),
    "traffic_cone": ((0.4, 0.4, 0.7), -1.4, False),
}


def background(rng: np.random.Generator, n: int, pc_range, points_per_surface: int) -> np.ndarray:
    """(n, 3) beam-like returns: points on ~n / points_per_surface surface
    patches at gamma-distributed range, 5% diffuse clutter."""
    r_max = float(min(pc_range[3], -pc_range[0])) - 0.5
    n_bg = n // 20
    n_fg = n - n_bg
    n_centres = max(n_fg // points_per_surface, 1)
    cr = np.minimum(np.abs(rng.gamma(2.0, 9.0, n_centres)), r_max)
    cth = rng.uniform(-np.pi, np.pi, n_centres)
    cz = rng.normal(-1.2, 0.6, n_centres)
    idx = rng.integers(0, n_centres, n_fg)
    x = cr[idx] * np.cos(cth[idx]) + rng.normal(0, 0.025, n_fg)
    y = cr[idx] * np.sin(cth[idx]) + rng.normal(0, 0.025, n_fg)
    z = cz[idx] + rng.normal(0, 0.25, n_fg)
    br = np.minimum(np.abs(rng.gamma(2.0, 9.0, n_bg)), r_max)
    bth = rng.uniform(-np.pi, np.pi, n_bg)
    xyz = np.stack([np.concatenate([x, br * np.cos(bth)]), np.concatenate([y, br * np.sin(bth)]),
                    np.concatenate([z, rng.normal(-1.2, 0.8, n_bg)])], 1)
    xyz[:, 2] = np.clip(xyz[:, 2], pc_range[2] + 0.05, pc_range[5] - 0.05)
    return xyz


def scene(rng: np.random.Generator, n_points: int, pc_range, n_objects: int, class_names,
          points_per_surface: int):
    """One labelled scene: (points (n_points, 5) [x, y, z, intensity, dt],
    boxes (M, 9) [x, y, z, l, w, h, vx, vy, yaw], names (M,)).  Objects
    ~10 m apart, their surface points scaled by footprint and range."""
    r_max = max(float(min(pc_range[3], -pc_range[0])) - 4.0, 1.0)
    r_min = min(4.0, r_max / 2)
    boxes = np.zeros((n_objects, 9), np.float32)
    names, clusters = [], []
    for i in range(n_objects):
        name = class_names[int(rng.integers(len(class_names)))]
        (l, w, h), zc, moving = CLASS_SPECS[name]
        l, w, h = l * rng.uniform(0.9, 1.1), w * rng.uniform(0.9, 1.1), h * rng.uniform(0.9, 1.1)
        for _ in range(50):
            r, th = rng.uniform(r_min, r_max), rng.uniform(-np.pi, np.pi)
            cx, cy = r * np.cos(th), r * np.sin(th)
            if i == 0 or np.hypot(boxes[:i, 0] - cx, boxes[:i, 1] - cy).min() > 10.0:
                break
        yaw = rng.uniform(-np.pi, np.pi)
        vel = rng.normal(0, 2.5, 2) if moving else np.zeros(2)
        boxes[i] = [cx, cy, zc, l, w, h, vel[0], vel[1], yaw]
        names.append(name)
        npts = int(np.clip(900.0 * np.sqrt(l * w) / max(r / 10.0, 1.0), 60, 1500))
        u = rng.uniform(-0.5, 0.5, (npts, 3))
        face = rng.integers(0, 3, npts)
        for axis in (0, 1):
            u[face == axis, axis] = 0.5 * np.sign(rng.standard_normal((face == axis).sum()))
        u[face == 2, 2] = 0.5
        local = u * [l, w, h] + rng.normal(0, 0.02, (npts, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        clusters.append(np.stack([cx + local[:, 0] * c - local[:, 1] * s,
                                  cy + local[:, 0] * s + local[:, 1] * c, zc + local[:, 2]], 1))
    obj = np.concatenate(clusters)
    xyz = np.concatenate([obj, background(rng, max(n_points - len(obj), 1000), pc_range, points_per_surface)])
    xyz = xyz[:n_points]
    pts = np.zeros((len(xyz), 5), np.float32)
    pts[:, :3] = xyz
    pts[:, 3] = rng.uniform(0, 255, len(xyz))
    pts[:, 4] = rng.uniform(0, 0.45, len(xyz))
    return pts, boxes, np.array(names)


# ------------------------------------------------------------- the targets
def gaussian_radius(height: float, width: float, min_overlap: float) -> float:
    """CornerNet's radius (det3d center_utils.py:12-32)."""
    b1 = height + width
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * width * height * (1 - min_overlap) / (1 + min_overlap))) / 2
    b2 = 2 * (height + width)
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * (1 - min_overlap) * width * height)) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (height + width)
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * (min_overlap - 1) * width * height)) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap: np.ndarray, x: int, y: int, radius: int) -> None:
    """Max-composite a gaussian of ``radius`` at (x, y) into (H, W)."""
    d = 2 * radius + 1
    sigma = d / 6
    g = np.exp(-(np.arange(-radius, radius + 1)[None] ** 2 + np.arange(-radius, radius + 1)[:, None] ** 2)
               / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    h, w = heatmap.shape
    left, right = min(x, radius), min(w - x, radius + 1)
    top, bottom = min(y, radius), min(h - y, radius + 1)
    patch = heatmap[y - top:y + bottom, x - left:x + right]
    gp = g[radius - top:radius + bottom, radius - left:radius + right]
    if min(patch.shape) > 0 and min(gp.shape) > 0:
        np.maximum(patch, gp, out=patch)


def targets(boxes: np.ndarray, names: np.ndarray, cm: dict) -> dict:
    """det3d AssignLabel: per task group the heatmap (H, W, C), centre
    indices, mask, class, the 10-dim box code and the 7-dim box."""
    pr, vs = np.asarray(cm["pc_range"], np.float64), np.asarray(cm["voxel_size"], np.float64)
    grid = np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)
    m = int(cm["max_objs"])
    out = {k: [] for k in ("hm", "anno_box", "ind", "mask", "cat", "gt_boxes")}
    for t, task in enumerate(cm["tasks"]):
        f = int(cm["out_size_factor"][t])
        w, h = int(grid[0]) // f, int(grid[1]) // f
        hm = np.zeros((h, w, len(task)), np.float32)
        anno, ind = np.zeros((m, 10), np.float32), np.zeros(m, np.int64)
        mask, cat, gt7 = np.zeros(m, np.uint8), np.zeros(m, np.int64), np.zeros((m, 7), np.float32)
        j = 0
        for box, name in zip(boxes, names):
            if name not in task or j >= m:
                continue
            sx, sy = box[3] / vs[0] / f, box[4] / vs[1] / f
            radius = max(int(cm["min_radius"]), int(gaussian_radius(sy, sx, cm["gaussian_overlap"])))
            cx, cy = (box[0] - pr[0]) / vs[0] / f, (box[1] - pr[1]) / vs[1] / f
            ix, iy = int(cx), int(cy)
            if not (0 <= ix < w and 0 <= iy < h):
                continue
            c = task.index(name)
            draw_gaussian(hm[:, :, c], ix, iy, radius)
            cat[j], ind[j], mask[j] = c, iy * w + ix, 1
            anno[j] = [cx - ix, cy - iy, box[2], np.log(box[3]), np.log(box[4]), np.log(box[5]),
                       box[6], box[7], np.sin(box[8]), np.cos(box[8])]
            gt7[j] = [*box[:6], box[8]]
            j += 1
        for k, v in zip(out, (hm, anno, ind, mask, cat, gt7)):
            out[k].append(v)
    return out


def batch(rng: np.random.Generator, cfg: dict, traffic: dict, size: int, with_targets: bool) -> dict:
    """``size`` scenes collated: points (B, max_points, 5), points_mask
    (B, max_points) and, for training, the per-task target lists."""
    pc_range = cfg["model"]["reader"]["pc_range"]
    cm = cfg["data"]["train_dataset"]["prepare_label"]["centermap"]
    names = [n for task in cm["tasks"] for n in task]
    lo, hi = traffic["objects"]
    n, slots = int(traffic["points_per_frame"]), int(traffic["max_points"])
    pts = np.zeros((size, slots, 5), np.float32)
    mask = np.zeros((size, slots), bool)
    per = []
    for i in range(size):
        p, boxes, labels = scene(rng, n, pc_range, int(rng.integers(lo, hi + 1)), names,
                                 int(traffic["points_per_surface"]))
        pts[i, :len(p)], mask[i, :len(p)] = p, True
        if with_targets:
            per.append(targets(boxes, labels, cm))
    out = {"points": pts, "points_mask": mask}
    if with_targets:
        for k in per[0]:
            out[k] = [np.stack([s[k][t] for s in per]) for t in range(len(per[0][k]))]
    return out


def pool(cfg: dict, traffic: dict, seed: int) -> list:
    """The cell's pool of batches, made from ``seed``."""
    rng = np.random.default_rng(seed % 2**64)
    train = traffic["mode"] == "train"
    return [batch(rng, cfg, traffic, int(traffic["batch"]), train) for _ in range(int(traffic["pool_batches"]))]
