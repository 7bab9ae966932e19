#!/usr/bin/env python
"""Offline dataset preparation CLI.

The port's own copy of pillarnext_tpu/cli/create_data.py (parity with the
reference tools/create_data.py:7-24).  Each prep converts the raw dataset
into infos pickles, then builds the train split's GT database:

    python -m pillarnext_tpu_torch.cli.create_data nuscenes_data_prep \\
        --root-path /data/nuscenes [--version v1.0-trainval] [--nsweeps 10]
    python -m pillarnext_tpu_torch.cli.create_data waymo_data_prep \\
        --root-path /data/waymo [--split train] [--nsweeps 1]
    (or: pnx-torch-create-data ...)

The nuScenes prep needs the ``nuscenes`` devkit and ``pyquaternion``; the
Waymo prep needs ``tensorflow`` and ``waymo_open_dataset`` (it reads
``<root>/tfrecord_{split}/*.tfrecord*``).  The GT-database step needs
neither.
"""

from __future__ import annotations

import argparse

from pillarnext_tpu_torch.cli.create_gt_database import create_groundtruth_database


def nuscenes_data_prep(root_path: str, version: str, nsweeps: int):
    from pillarnext_tpu_torch.data.nusc_converter import create_nuscenes_infos

    create_nuscenes_infos(root_path, version=version, nsweeps=nsweeps)
    if version != "v1.0-test":
        create_groundtruth_database(
            "nuscenes",
            root_path,
            info_path=f"infos_train_{nsweeps}sweeps_withvelo_filterZero.pkl",
            nsweeps=nsweeps,
        )


def waymo_data_prep(root_path: str, split: str, nsweeps: int):
    from pillarnext_tpu_torch.data.waymo_converter import create_waymo_infos

    create_waymo_infos(root_path, split=split)
    if split == "train":
        create_groundtruth_database(
            "waymo",
            root_path,
            info_path=f"waymo_infos_{split}.pkl",
            nsweeps=nsweeps,
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nuscenes_data_prep")
    p.add_argument("--root-path", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--nsweeps", type=int, default=10)

    p = sub.add_parser("waymo_data_prep")
    p.add_argument("--root-path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--nsweeps", type=int, default=1)

    args = parser.parse_args(argv)
    if args.cmd == "nuscenes_data_prep":
        nuscenes_data_prep(args.root_path, args.version, args.nsweeps)
    else:
        waymo_data_prep(args.root_path, args.split, args.nsweeps)


if __name__ == "__main__":
    main()
