#!/usr/bin/env python
"""GT-database builder for copy-paste augmentation.

The port's own copy of pillarnext_tpu/cli/create_gt_database.py
(capability parity with the reference tools/create_gt_database.py:9-149):
read the train split through the port's dataset with
``create_database=True`` (raw annotations kept, no augmentation, no GT
paste), crop the points inside each GT box with the host geometry
library's point-in-rotated-box test (core/box_ops.points_in_rbbox, which
raises if the library cannot be built), recentre each crop on its box,
and write one ``.bin`` a box plus a ``dbinfos_train_{N}sweeps_withvelo.pkl``
index that data/sampler.py reads.  Waymo keeps 1/4 of the vehicles and 1/2
of the pedestrians (:73-83), drawn from one ``np.random.default_rng(0)`` in
box order, so the output equals the JAX package's bit for bit.  It needs
no dataset devkit.

    python -m pillarnext_tpu_torch.cli.create_gt_database nuscenes \\
        --root-path /data/nuscenes \\
        --info-path infos_train_10sweeps_withvelo_filterZero.pkl --nsweeps 10
    (or: pnx-torch-create-gt-database ...)
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from pillarnext_tpu_torch.core import box_ops

DATASETS = ("nuscenes", "waymo")


def create_groundtruth_database(
    dataset_type: str,
    root_path: str,
    info_path: str,
    nsweeps: int = 1,
    db_path: str | None = None,
    dbinfo_path: str | None = None,
) -> dict[str, list]:
    """Write the crops and the dbinfos pickle; returns the dbinfos."""
    from pillarnext_tpu_torch.data.datasets import NuScenesDataset, WaymoDataset

    if dataset_type not in DATASETS:
        raise ValueError(dataset_type)
    root = Path(root_path)
    db_path = Path(db_path or root / f"gt_database_{nsweeps}sweeps_withvelo")
    dbinfo_path = dbinfo_path or root / f"dbinfos_train_{nsweeps}sweeps_withvelo.pkl"
    db_path.mkdir(parents=True, exist_ok=True)

    dataset_cls = NuScenesDataset if dataset_type == "nuscenes" else WaymoDataset
    dataset = dataset_cls(
        info_path=info_path,
        root_path=root_path,
        nsweeps=nsweeps,
        loading_pipelines=["load_pointcloud", "load_box3d"],
        create_database=True,
        use_gt_sampling=False,
    )

    db_infos: dict[str, list] = {}
    rng = np.random.default_rng(0)
    for index in range(len(dataset)):
        # no augmentation, GT paste or frame dropping: the pipeline draws nothing
        sample = dataset.get(index, np.random.RandomState(index))
        points = sample["points"]
        ann = sample["annotations"]
        boxes = np.asarray(ann["gt_boxes"], np.float64)
        names = np.asarray(ann["gt_names"])
        if boxes.shape[0] == 0:
            continue

        inside = box_ops.points_in_rbbox(points, boxes)
        for i in range(boxes.shape[0]):
            name = str(names[i])
            # Waymo class subsampling (create_gt_database.py:73-83)
            if dataset_type == "waymo":
                if name == "vehicle" and rng.uniform() > 0.25:
                    continue
                if name == "pedestrian" and rng.uniform() > 0.5:
                    continue

            crop = points[inside[:, i]].copy()
            crop[:, :3] -= boxes[i, :3]  # recentre (:105)
            filename = f"{index}_{name}_{i}.bin"
            crop.astype(np.float32).tofile(db_path / filename)

            db_infos.setdefault(name, []).append(
                {
                    "name": name,
                    "path": str(Path(db_path.name) / filename),
                    "image_idx": index,
                    "gt_idx": i,
                    "box3d_lidar": boxes[i].astype(np.float32),
                    "num_points_in_gt": int(crop.shape[0]),
                    "difficulty": 0,
                }
            )
        if index % 500 == 0:
            print(f"{index}/{len(dataset)}", flush=True)

    for k, v in db_infos.items():
        print(f"{k}: {len(v)} crops")
    with open(dbinfo_path, "wb") as f:
        pickle.dump(db_infos, f)
    return db_infos


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dataset", choices=DATASETS)
    parser.add_argument("--root-path", required=True)
    parser.add_argument("--info-path", required=True)
    parser.add_argument("--nsweeps", type=int, default=1)
    args = parser.parse_args(argv)
    create_groundtruth_database(args.dataset, args.root_path, args.info_path, args.nsweeps)


if __name__ == "__main__":
    main()
