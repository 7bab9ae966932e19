#!/usr/bin/env python
"""Host data-pipeline throughput across loader worker counts.

Counterpart of tools/loader_bench.py:48-198.  Writes a synthetic
nuScenes-format tree at a real sample's cost (``make_synthetic_nusc``: 10
sweeps of 25,000 points a sample, 40 boxes, a GT database of 32 crops a
class, from ``default_rng(seed)``), builds the train pipeline on it
(``make_dataset``: GT paste, rotation, scaling, translation and flip, and
``AssignLabel`` at the flagship's 1344^2 grid), then, for each worker
count w, iterates the port's ``DataLoader`` (B = 4, 200,000
``max_points``): first one batch from every worker (the forks, the page
cache), then ``--trips`` x max(w, 2) batches timed, as batches/s and
frames/s.  Each worker queues up to 5 batches ahead, so a window that
short of the queues' depth (JAX's one epoch of 32 samples: 7 batches at
8 workers) times the queues draining; here every worker makes ``--trips``
trips of its own in the window, and the tree holds enough samples for the
largest w.  Beside each rate stand the workers' mean seconds a batch and
the frames/s that a flagship train step of ``--step-ms`` consumes at that
batch (null without it): JAX's pass criterion is that the loader outruns
the card.

    python -m pillarnext_tpu_torch.tools.loader_bench [--workers 0 2 4 8] \\
        [--trips 4] [--batch 4] [--max-points 200000] [--step-ms MS] \\
        [--samples N] [--root DIR]

The tree goes to a temporary directory unless ``--root`` names one.  It
prints one line a worker count and a JSON record.  No device is used.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np

from pillarnext_tpu_torch.data.assign import AssignLabel
from pillarnext_tpu_torch.data.augmentation import Flip, Rotation, Scaling, Translation
from pillarnext_tpu_torch.data.datasets import NuScenesDataset
from pillarnext_tpu_torch.data.loader import DataLoader
from pillarnext_tpu_torch.data.sampler import DataBaseSampler, DBFilterByMinNumPoint

TASKS = [
    ["car"],
    ["truck", "construction_vehicle"],
    ["bus", "trailer"],
    ["barrier"],
    ["motorcycle", "bicycle"],
    ["pedestrian", "traffic_cone"],
]
CLASSES = [c for t in TASKS for c in t]
PC_RANGE = [-50.4, -50.4, -5.0, 50.4, 50.4, 3.0]
VOXEL = [0.075, 0.075, 8.0]


def make_synthetic_nusc(root: Path, n_samples: int, pts_per_sweep=25_000, seed=0):
    """JAX's tree (tools/loader_bench.py:48-115), the same draws in the
    same order: ``samples/lidar_{i}.bin`` and 9 ``sweep_{i}_{s}.bin`` of
    (N, 5) f32, ``infos.pkl``, 32 crops a class under ``gtdb/`` and
    ``dbinfos.pkl``."""
    rng = np.random.default_rng(seed)
    (root / "samples").mkdir(parents=True, exist_ok=True)
    (root / "gtdb").mkdir(exist_ok=True)

    def scan(n):
        p = np.zeros((n, 5), np.float32)
        r = np.minimum(np.abs(rng.gamma(2.0, 9.0, n)), 50.0)
        th = rng.uniform(-np.pi, np.pi, n)
        p[:, 0], p[:, 1] = r * np.cos(th), r * np.sin(th)
        p[:, 2] = rng.normal(-1.2, 0.8, n)
        p[:, 3] = rng.uniform(0, 255, n)
        return p

    infos = []
    for i in range(n_samples):
        path = f"samples/lidar_{i}.bin"
        scan(pts_per_sweep).tofile(root / path)
        sweeps = []
        for s in range(9):
            sp = f"samples/sweep_{i}_{s}.bin"
            scan(pts_per_sweep).tofile(root / sp)
            tm = np.eye(4)
            tm[:2, 3] = rng.normal(0, 0.3, 2)
            sweeps.append({"lidar_path": sp, "transform_matrix": tm, "time_lag": 0.05 * (s + 1)})
        nb = 40
        boxes = np.zeros((nb, 9))
        boxes[:, :2] = rng.uniform(-45, 45, (nb, 2))
        boxes[:, 2] = rng.uniform(-1.5, 0.5, nb)
        boxes[:, 3:6] = rng.uniform(0.5, 6.0, (nb, 3))
        boxes[:, 6:8] = rng.uniform(-3, 3, (nb, 2))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, nb)
        infos.append({"lidar_path": path, "token": f"token_{i}", "sweeps": sweeps, "timestamp": float(i),
                      "gt_boxes": boxes, "gt_names": rng.choice(CLASSES, nb)})
    with open(root / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)

    db = {c: [] for c in CLASSES}
    for c in CLASSES:
        for j in range(32):
            crop = (rng.normal(0, 0.8, (200, 5))).astype(np.float32)
            p = f"gtdb/{c}_{j}.bin"
            crop.tofile(root / p)
            box = np.zeros(9, np.float32)
            box[:2] = rng.uniform(-40, 40, 2)
            box[3:6] = rng.uniform(0.5, 5.0, 3)
            box[8] = rng.uniform(-np.pi, np.pi)
            db[c].append({"name": c, "path": p, "box3d_lidar": box, "num_points_in_gt": 200, "difficulty": 0})
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(db, f)


def make_dataset(root: Path) -> NuScenesDataset:
    """JAX's pipeline (tools/loader_bench.py:118-162) on the tree."""
    sampler = functools.partial(
        DataBaseSampler,
        root_path=str(root),
        dbinfo_path="dbinfos.pkl",
        groups=[
            {"car": 2},
            {"truck": 3, "construction_vehicle": 7},
            {"bus": 4, "trailer": 6},
            {"barrier": 2},
            {"motorcycle": 6, "bicycle": 6},
            {"pedestrian": 2, "traffic_cone": 2},
        ],
        db_prepor={"filter": DBFilterByMinNumPoint({c: 5 for c in CLASSES})},
        rate=1.0,
        gt_drop_percentage=0.0,
        gt_drop_max_keep_points=-1,
        point_dim=5,
    )
    assigner = AssignLabel(tasks=TASKS, gaussian_overlap=0.1, max_objs=500, min_radius=2, pc_range=PC_RANGE,
                           voxel_size=VOXEL, out_size_factor=[4] * len(TASKS))
    return NuScenesDataset(
        info_path="infos.pkl",
        root_path=str(root),
        nsweeps=10,
        class_names=TASKS,
        resampling=False,
        use_gt_sampling=True,
        sampler=sampler,
        loading_pipelines=["load_pointcloud", "load_box3d"],
        augmentation={
            "rotation": Rotation([-0.785, 0.785]),
            "scaling": Scaling([0.9, 1.1]),
            "translation": Translation(0.5),
            "flip": Flip([0.5, 0.5]),
        },
        prepare_label={"centermap": assigner},
    )


def warm_batches(workers: int) -> int:
    """Batches taken before the clock starts: one from every worker."""
    return max(workers, 1)


def timed_batches(workers: int, trips: int) -> int:
    """Batches timed at ``workers``: ``trips`` from each worker (from 2
    for no or one worker, to steady the clock)."""
    return trips * max(workers, 2)


def samples_needed(workers, batch_size: int, trips: int) -> int:
    """The tree's samples for every worker count's warm and timed batches."""
    return batch_size * max(warm_batches(w) + timed_batches(w, trips) for w in workers)


def rate(ds, workers: int, batch_size: int, max_points: int, trips: int) -> dict:
    """The loader's rate at ``workers`` workers: ``timed_batches`` after
    ``warm_batches``; the workers' mean seconds a timed batch."""
    loader = DataLoader(ds, batch_size=batch_size, max_points=max_points, shuffle=True, seed=0, num_workers=workers)
    warm, n = warm_batches(workers), timed_batches(workers, trips)
    it = iter(loader)
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    seconds = time.perf_counter() - t0
    it.close()
    return {"workers": workers, "warm_batches": warm, "batches": n, "seconds": seconds, "batches_per_s": n / seconds,
            "frames_per_s": n * batch_size / seconds,
            "worker_s_per_batch": statistics.mean(loader.load_s[warm:warm + n])}


def run(n_samples: int | None = None, workers=(0, 2, 4, 8), batch_size: int = 4, max_points: int = 200_000,
        step_ms: float | None = None, root=None, pts_per_sweep: int = 25_000, trips: int = 4, log=print) -> dict:
    """The benchmark's record: the tree's seconds, the card's consumption
    (``step_frames_per_s``: ``batch_size`` frames a ``step_ms``, or null)
    and one record a worker count (``keeps_up``: its frames/s at least the
    card's, null without ``step_ms``).  ``n_samples`` defaults to
    ``samples_needed``; fewer raise."""
    need = samples_needed(workers, batch_size, trips)
    n_samples = need if n_samples is None else n_samples
    if n_samples < need:
        raise ValueError(f"{n_samples} samples are fewer than the {need} that workers {list(workers)} need "
                         f"for {trips} trips at batch {batch_size}")
    with tempfile.TemporaryDirectory() as td:
        tree = Path(root) if root is not None else Path(td)
        t0 = time.perf_counter()
        make_synthetic_nusc(tree, n_samples, pts_per_sweep)
        rec = {"samples": n_samples, "points_per_sweep": pts_per_sweep, "sweeps": 10, "batch_size": batch_size,
               "max_points": max_points, "trips": trips, "tree_seconds": time.perf_counter() - t0,
               "cpu_count": os.cpu_count(), "step_ms": step_ms,
               "step_frames_per_s": None if step_ms is None else batch_size * 1e3 / step_ms, "rates": []}
        log(f"synthetic tree ({n_samples} samples, 10 x {pts_per_sweep} points): {rec['tree_seconds']:.1f} s")
        ds = make_dataset(tree)
        for w in workers:
            r = rate(ds, w, batch_size, max_points, trips)
            r["keeps_up"] = None if step_ms is None else r["frames_per_s"] >= rec["step_frames_per_s"]
            rec["rates"].append(r)
            log(f"workers={w}: {r['batches']} batches in {r['seconds']:5.1f} s -> "
                f"{r['batches_per_s']:5.2f} batches/s, {r['frames_per_s']:6.2f} frames/s, "
                f"{r['worker_s_per_batch']:.3f} s a batch in a worker "
                f"(a train step consumes {rec['step_frames_per_s']})")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The host data pipeline's throughput across loader workers.")
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 2, 4, 8])
    ap.add_argument("--trips", type=int, default=4, help="timed batches from each worker")
    ap.add_argument("--samples", type=int, default=None, help="the tree's samples (default: what the trips need)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-points", type=int, default=200_000)
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a flagship train step's ms at this batch: the frames/s the card consumes")
    ap.add_argument("--root", default=None, help="write the tree here (default: a temporary directory)")
    args = ap.parse_args(argv)
    rec = run(args.samples, args.workers, args.batch, args.max_points, args.step_ms, args.root, trips=args.trips,
              log=lambda s: print(s, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
