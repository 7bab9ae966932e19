"""Seeded synthetic training batches (host, numpy).

Labelled scenes from utils/synth.synth_detection_scene, targets from the
experiment's own ``prepare_label.centermap`` (data/assign.AssignLabel),
collated to the dataloader's static ``max_points``: batches for tests and
measurements that need no dataset (the datasets are data/datasets.py).
"""

from __future__ import annotations

import numpy as np

from pillarnext_tpu_torch.data.collate import collate
from pillarnext_tpu_torch.utils.config import instantiate
from pillarnext_tpu_torch.utils.registry import PORT_REGISTRY
from pillarnext_tpu_torch.utils.synth import synth_detection_scene


def synthetic_batches(cfg: dict, n_batches: int, batch_size: int, n_points: int,
                      seed: int = 0, n_objects: int = 24, max_points: int | None = None) -> list[dict]:
    """``n_batches`` collated batches (points (B, max_points, 5), points_mask,
    per-task hm / anno_box / ind / mask / cat / gt_boxes) from a resolved
    experiment config; the same seed gives the same arrays."""
    assigner = instantiate(cfg["data"]["train_dataset"]["prepare_label"]["centermap"], PORT_REGISTRY)
    class_names = [name for task in assigner.tasks for name in task]
    pc_range = cfg["model"]["reader"]["pc_range"]
    max_points = int(max_points or cfg["dataloader"]["max_points"])
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        samples = []
        for _ in range(batch_size):
            pts, boxes, names = synth_detection_scene(rng, n_points, pc_range, n_objects, class_names)
            targets = assigner({"annotations": {"gt_boxes": boxes, "gt_names": names}})
            del targets["annotations"]
            samples.append({"points": pts, **targets})
        batches.append(collate(samples, max_points, rng))
    return batches
