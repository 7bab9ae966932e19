"""Tiny stand-ins of the benchmark's cells for the CPU tests: each
configuration at a 16 m grid and narrow widths, float32, with the cell's
own traffic shrunk to a few thousand points a frame."""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from benchmark import common
from benchmark.spec import ROOT, Spec

PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
OVERRIDES = {
    "nusc_det_pp18_aspp_iou_sp": [
        f"model.reader.pc_range={PC}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.reader.train_pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32", "model.head.in_channels=32",
        "+model.head.share_conv_channel=32", "model.dtype=float32"],
    "nusc_det_voxel18_aspp_iou_sp": [
        f"model.reader.pc_range={PC}", "model.reader.voxel_size=[0.25,0.25,0.2]",
        "model.reader.voxel_capacity=4096", "model.backbone.ds_num_filters=[8,12,16,16]",
        "model.backbone.out_channels=16", "model.neck.in_channels=32", "model.head.in_channels=32",
        "+model.head.share_conv_channel=32", "model.dtype=float32"],
}
TRAFFIC = {"points_per_frame": 3000, "max_points": 4000, "objects": [3, 5], "pool_batches": 3,
           "trace_steps": 1, "host_batches": 2, "trace_batches": 2, "check_batches": 1}


def spec(cell: str, batch: int = 2, root: Path = ROOT) -> Spec:
    """The cell's Spec with its configuration and traffic cut to size."""
    from pillarnext_tpu_torch.utils.config import load_experiment

    s = Spec(cell, root)
    name = s.cell["config"]
    s.config = copy.deepcopy(s.config)
    s.config["experiment"] = load_experiment(
        ROOT / f"pillarnext_tpu/configs/experiments/{name}.yaml", OVERRIDES[name])
    s.traffic = dict(s.traffic, **TRAFFIC, batch=batch)
    return s


def run(cell: str, seed: int = 0, trace: bool = False, program=None, batch: int = 2):
    """One run of the tiny cell on the CPU (a training cell's step
    replaced by ``program`` when given); its ``common.Run``."""
    import importlib

    s = spec(cell, batch)
    r = common.Run(s, seed, 0.5, trace, torch.device("cpu"), 0.0)
    mode = importlib.import_module(f"benchmark.modes.{s.traffic['mode']}")
    if program is None:
        mode.run(r)
    else:
        mode.run(r, program=program)
    return r
