#!/usr/bin/env python
"""End-to-end learning check: overfit a full config-scale model on one
synthetic scene and require the detector to find the planted objects.

Counterpart of tools/overfit_sanity.py: the flagship PillarNeXt-B at the
1344^2 grid by default, ``--config voxel18`` the fully sparse 3-D backbone
at the 40 x 1344^2 grid, or an experiment YAML.  The same scene (6 cars
and 4 pedestrians of 600 points each over ground clutter, from
``default_rng(0)``), the same ``AssignLabel`` and collate, the port's
``Trainer`` step with AdamW at a one-cycle peak of 1.5e-3, and JAX's bar:
the last logged loss under half the first, and at least 8 of the 10
objects within 2 m of a detection.  The detections are decoded from
train-mode features, as JAX decodes them: a single-batch overfit lets the
net lean on batch statistics that the BN running averages lag behind.

    python -m pillarnext_tpu_torch.tools.overfit_sanity [steps] \\
        [--config flagship|voxel18|PATH] [--device cuda:N|cpu] \\
        [--extent M] [--points N] [key.path=value ...]

``--extent`` scales the scene (50 m: JAX's; shrink it with the grid for a
CPU run) and ``--points`` its point count (60,000).  Keep ``steps`` at
~250 or more at full scale (JAX's note); 300 by default.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from pillarnext_tpu_torch.data.assign import AssignLabel
from pillarnext_tpu_torch.data.collate import collate
from pillarnext_tpu_torch.train.train_state import make_optimizer
from pillarnext_tpu_torch.train.trainer import Trainer, batch_to_device
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment

EXPERIMENTS = Path(__file__).resolve().parents[2] / "pillarnext_tpu" / "configs" / "experiments"
CONFIGS = {
    "flagship": "nusc_det_pp18_aspp_iou_sp.yaml",
    "voxel18": "nusc_det_voxel18_aspp_iou_sp.yaml",
}


def scene(extent: float = 50.0, n_points: int = 60_000):
    """JAX's scene (tools/overfit_sanity.py:57-83), its lateral extents
    scaled by ``extent`` / 50: (points (N, 5), gt_boxes (10, 9), names)."""
    rng = np.random.default_rng(0)
    f = extent / 50.0
    gt = np.zeros((10, 9), np.float32)
    gt[:6, :2] = rng.uniform(-30 * f, 30 * f, (6, 2))
    gt[:6, 2] = -1.0
    gt[:6, 3:6] = [4.5, 1.9, 1.6]
    gt[:6, 8] = rng.uniform(-np.pi, np.pi, 6)
    gt[6:, :2] = rng.uniform(-20 * f, 20 * f, (4, 2))
    gt[6:, 2] = -0.9
    gt[6:, 3:6] = [0.7, 0.7, 1.7]
    names = np.array(["car"] * 6 + ["pedestrian"] * 4)

    pts = np.zeros((n_points, 5), np.float32)
    pts[:, 0] = rng.uniform(-50 * f, 50 * f, n_points)
    pts[:, 1] = rng.uniform(-50 * f, 50 * f, n_points)
    pts[:, 2] = rng.normal(-1.8, 0.05, n_points)
    for i, box in enumerate(gt):
        sl = slice(i * 600, (i + 1) * 600)
        local = rng.uniform(-0.5, 0.5, (600, 3)) * box[3:6]
        c, s = np.cos(box[8]), np.sin(box[8])
        pts[sl, 0] = box[0] + local[:, 0] * c - local[:, 1] * s
        pts[sl, 1] = box[1] + local[:, 0] * s + local[:, 1] * c
        pts[sl, 2] = box[2] + local[:, 2]
    pts[:, 3] = rng.uniform(0, 1, n_points)
    return pts, gt, names


def hits(boxes: np.ndarray, gt: np.ndarray, radius: float = 2.0) -> int:
    """Objects of ``gt`` with a box centre within ``radius`` m."""
    if len(boxes) == 0:
        return 0
    return sum(float(np.linalg.norm(boxes[:, :2] - g[:2], axis=1).min()) < radius for g in gt)


def run(config: str = "flagship", steps: int = 300, device="cuda:0", overrides=(), extent: float = 50.0,
        n_points: int = 60_000, log=print) -> dict:
    """Overfit, decode and count; returns the losses logged every 5 steps,
    the seconds, the detections' count and the hits (top 10 and all).
    Checks nothing: ``check`` holds the result to JAX's bar."""
    path = Path(config) if config not in CONFIGS else EXPERIMENTS / CONFIGS[config]
    log(f"config: {path.name}, steps: {steps}")
    cfg = load_experiment(path, list(overrides))
    model = builders.build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0),
                                 train=True)

    pts, gt, names = scene(extent, n_points)
    pl = cfg["data"]["train_dataset"]["prepare_label"]["centermap"]
    assigner = AssignLabel(
        tasks=pl["tasks"], gaussian_overlap=pl["gaussian_overlap"], max_objs=500,
        min_radius=pl["min_radius"], pc_range=cfg["model"]["reader"]["pc_range"],
        voxel_size=cfg["model"]["reader"]["voxel_size"], out_size_factor=pl["out_size_factor"],
    )
    res = assigner({"token": "t", "points": pts, "annotations": {"gt_boxes": gt, "gt_names": names}})
    del res["annotations"]
    batch = collate([res], max_points=n_points)
    batch.pop("token", None)

    opt, schedule = make_optimizer(list(model.parameters()), max_lr=1.5e-3, total_steps=steps, pct_start=0.2)
    trainer = Trainer(model, optimizer=opt, lr_schedule=schedule, device=device)
    example = batch_to_device(batch, trainer.device)
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        scalars, _ = trainer.train_step(example)
        if i % 5 == 0 or i == steps - 1:
            losses.append(float(scalars["loss"]))
            log(f"step {i}: loss {losses[-1]:.3f}")
    seconds = time.perf_counter() - t0
    log(f"{steps} steps in {seconds:.0f}s")

    model.train()
    with torch.no_grad(), model.precision():
        preds = model(example["points"], example["points_mask"])
        dets = model.head.predict(preds, model.post_processing)
    valid = dets["valid"][0].cpu().numpy()
    boxes = dets["box3d_lidar"][0].float().cpu().numpy()[valid]
    scores = dets["scores"][0].float().cpu().numpy()[valid]
    labels = dets["label_preds"][0].cpu().numpy()[valid]
    log(f"detections: {int(valid.sum())} (cars={(labels == 0).sum()}, peds={(labels == 9).sum()})")
    order = np.argsort(-scores)
    log("top-10 dets (x, y, score, label):")
    for i in order[:10]:
        log(f"  {boxes[i, 0]:7.2f} {boxes[i, 1]:7.2f}  s={scores[i]:.3f} l={labels[i]}")
    log("gt (x, y, cls):")
    for g, n in zip(gt, names):
        log(f"  {g[0]:7.2f} {g[1]:7.2f}  {n}")
    result = {"config": path.name, "steps": steps, "seconds": seconds, "losses": losses,
              "detections": int(valid.sum()), "hits_top10": hits(boxes[order[:10]], gt),
              "hits_all": hits(boxes, gt)}
    log(f"recovered within 2m: top-10 {result['hits_top10']}/10, all dets {result['hits_all']}/10")
    return result


def check(result: dict) -> None:
    """JAX's bar (tools/overfit_sanity.py:144-152): raises unless the last
    logged loss is under half the first and 8 of the 10 objects are hit."""
    losses = result["losses"]
    if not losses[-1] < losses[0] * 0.5:
        raise AssertionError(f"the loss did not halve: {losses[0]} -> {losses[-1]}")
    if result["hits_all"] < 8:
        raise AssertionError(f"{result['hits_all']} of 10 objects found within 2 m, 8 needed")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Overfit one synthetic scene and find its objects.")
    p.add_argument("steps", nargs="?", type=int, default=300)
    p.add_argument("--config", default="flagship", help="flagship, voxel18 or an experiment YAML")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--extent", type=float, default=50.0, help="the scene's half extent in metres")
    p.add_argument("--points", type=int, default=60_000)
    p.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    args = p.parse_args(argv)
    result = run(args.config, args.steps, args.device, args.overrides, args.extent, args.points,
                 log=lambda s: print(s, flush=True))
    check(result)
    print("OVERFIT SANITY PASS")
    return result


if __name__ == "__main__":
    main()
