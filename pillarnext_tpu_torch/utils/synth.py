"""Synthetic LiDAR-like point clouds and labelled scenes (host, numpy).

The port's own copy of pillarnext_tpu/utils/synth.py:20-181, with the same
seeds giving the same arrays and files.  Real spinning-LiDAR returns are
beam-structured: points concentrate on surfaces, so a multi-sweep nuScenes
frame of ~200-300k points occupies only ~40-60k pillars of the 1344^2 x
0.075 m grid.  The generator clusters points on ~n/10 surface patches with
~2.5 cm lateral spread plus a diffuse 5% background, radial density
following the range falloff of returns.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

# class -> ((l, w, h), z_center, moving): nuScenes-plausible box sizes
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
    # waymo naming (same physical archetypes)
    "vehicle": ((4.7, 2.0, 1.7), -1.0, True),
    "cyclist": ((1.8, 0.7, 1.7), -0.9, True),
}


def lidar_like_points(
    batch: int,
    n_points: int,
    pc_range,
    seed: int = 0,
    points_per_surface: int = 10,
):
    """(B, N, 5) [x, y, z, intensity, dt] float32 + (B, N) bool mask."""
    rng = np.random.default_rng(seed)
    r_max = float(min(pc_range[3], -pc_range[0])) - 0.5
    pts = np.zeros((batch, n_points, 5), np.float32)
    n_bg = n_points // 20
    n_fg = n_points - n_bg
    n_centers = max(n_fg // points_per_surface, 1)
    for b in range(batch):
        # surface patches: radial falloff like real returns
        cr = np.minimum(np.abs(rng.gamma(2.0, 9.0, n_centers)), r_max)
        cth = rng.uniform(-np.pi, np.pi, n_centers)
        cz = rng.normal(-1.2, 0.6, n_centers)
        cidx = rng.integers(0, n_centers, n_fg)
        x = cr[cidx] * np.cos(cth[cidx]) + rng.normal(0, 0.025, n_fg)
        y = cr[cidx] * np.sin(cth[cidx]) + rng.normal(0, 0.025, n_fg)
        z = cz[cidx] + rng.normal(0, 0.25, n_fg)
        # diffuse background (clutter, long-range singles)
        br = np.minimum(np.abs(rng.gamma(2.0, 9.0, n_bg)), r_max)
        bth = rng.uniform(-np.pi, np.pi, n_bg)
        pts[b, :, 0] = np.concatenate([x, br * np.cos(bth)])
        pts[b, :, 1] = np.concatenate([y, br * np.sin(bth)])
        pts[b, :, 2] = np.clip(
            np.concatenate([z, rng.normal(-1.2, 0.8, n_bg)]),
            pc_range[2] + 0.05,
            pc_range[5] - 0.05,
        )
        pts[b, :, 3] = rng.uniform(0, 1, n_points)
        pts[b, :, 4] = rng.uniform(0, 0.45, n_points)
    return pts, np.ones((batch, n_points), bool)


def synth_detection_scene(
    rng: np.random.Generator,
    n_points: int,
    pc_range,
    n_objects: int = 24,
    class_names=None,
    points_per_surface: int = 10,
):
    """One labelled scene: planted objects with surface-clustered points over
    a beam-structured background (``lidar_like_points`` with
    ``points_per_surface``: more points a surface, fewer occupied pillars).

    Returns (points (N, 5) [x y z intensity ring], gt_boxes (M, 9)
    [x y z l w h vx vy yaw], gt_names (M,)), the info schema of the
    nuScenes converter.  Object point counts scale with footprint and fall
    off with range.
    """
    names = list(class_names) if class_names is not None else [
        n for n in CLASS_SPECS if n not in ("vehicle", "cyclist")
    ]
    r_max = max(float(min(pc_range[3], -pc_range[0])) - 4.0, 1.0)
    r_min = min(4.0, r_max / 2)
    boxes = np.zeros((n_objects, 9), np.float32)
    labels = []
    clusters = []
    for i in range(n_objects):
        name = names[int(rng.integers(len(names)))]
        (l, w, h), zc, moving = CLASS_SPECS[name]
        l *= rng.uniform(0.9, 1.1)
        w *= rng.uniform(0.9, 1.1)
        h *= rng.uniform(0.9, 1.1)
        # rejection-sample centres ~10 m apart so GT boxes never overlap
        for _ in range(50):
            r = rng.uniform(r_min, r_max)
            th = rng.uniform(-np.pi, np.pi)
            cx, cy = r * np.cos(th), r * np.sin(th)
            d = np.hypot(boxes[:i, 0] - cx, boxes[:i, 1] - cy)
            if i == 0 or d.min() > 10.0:
                break
        yaw = rng.uniform(-np.pi, np.pi)
        vel = rng.normal(0, 2.5, 2) if moving else np.zeros(2)
        boxes[i] = [cx, cy, zc, l, w, h, vel[0], vel[1], yaw]
        labels.append(name)
        # surface points: two visible faces + top edge, count ~ footprint / range
        npts = int(np.clip(900.0 * np.sqrt(l * w) / max(r / 10.0, 1.0), 60, 1500))
        u = rng.uniform(-0.5, 0.5, (npts, 3))
        face = rng.integers(0, 3, npts)
        u[face == 0, 0] = 0.5 * np.sign(rng.standard_normal((face == 0).sum()))
        u[face == 1, 1] = 0.5 * np.sign(rng.standard_normal((face == 1).sum()))
        u[face == 2, 2] = 0.5
        local = u * [l, w, h] + rng.normal(0, 0.02, (npts, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        px = cx + local[:, 0] * c - local[:, 1] * s
        py = cy + local[:, 0] * s + local[:, 1] * c
        pz = zc + local[:, 2]
        clusters.append(np.stack([px, py, pz], axis=1))

    obj = np.concatenate(clusters, axis=0)
    n_bg = max(n_points - len(obj), 1000)
    bg, _ = lidar_like_points(1, n_bg, pc_range, seed=int(rng.integers(2**31)),
                              points_per_surface=points_per_surface)
    xyz = np.concatenate([obj, bg[0, :, :3]], axis=0)[:n_points]
    pts = np.zeros((len(xyz), 5), np.float32)
    pts[:, :3] = xyz
    pts[:, 3] = rng.uniform(0, 255, len(xyz))
    return pts, boxes, np.array(labels)


def write_synthetic_nusc(
    root,
    n_scenes: int,
    n_points: int = 120_000,
    pc_range=(-50.4, -50.4, -5.0, 50.4, 50.4, 3.0),
    seed: int = 0,
    n_objects: int = 24,
) -> Path:
    """Write a nuScenes-format tree of ``n_scenes`` labelled single-sweep
    scans (``samples/scene_{i}.bin``) and their infos
    (``infos_synth.pkl``), which the nuScenes dataset reads for training
    and the self-contained ``detection_cvpr_2019`` scorer for evaluation.
    Identity ego and reference poses make the global frame the lidar
    frame.  Returns the infos path."""
    root = Path(root)
    (root / "samples").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(n_scenes):
        pts, boxes, names = synth_detection_scene(rng, n_points, pc_range, n_objects)
        path = f"samples/scene_{i}.bin"
        pts.tofile(root / path)
        infos.append({
            "lidar_path": path,
            "token": f"synth_{i}",
            "sweeps": [],
            "timestamp": float(i),
            "gt_boxes": boxes,
            "gt_names": names,
            "ref_from_car": np.eye(4, dtype=np.float64),
            "car_from_global": np.eye(4, dtype=np.float64),
        })
    with open(root / "infos_synth.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root / "infos_synth.pkl"
