#!/usr/bin/env python
"""Trained-weight detection-set parity of the port's MVF family
(mvf18_aspp) against the reference mirror at the Waymo config grid (2048^2
pillar view, 100 x 2560 cylinder view, 2 task groups).

Counterpart of tools/mvf_parity.py for the port: the port's Trainer
overfits waymo_det_mvf18_aspp_iou_car as its YAML gives it (bf16 on the
card) on a planted scene of 24 objects of its classes; its weights go into
the port's f32 eval model (``model.dtype=float32``, ``approx_topk=false``)
and, through ``state_dict_to_reference``, into the port's copy of the MVF
mirror (``reference_mirror_mvf.TMVFModel``: both views' decoration and PFN
stacks, dense view towers, bilinear readback, point MLPs, the coarse max),
which runs in full f32 on the device.  The port's detections
(``AdaptivePredictor.predict``, as served) must equal the mirror's
exactly: the same count (more than 0), every detection matched with its
label, boxes within 5e-2 and scores within 5e-3.  ``--heads`` compares
the raw head maps instead.

    python -m pillarnext_tpu_torch.tools.mvf_parity [--points 200000] \\
        [--seed 0] [--overfit 300] [--heads] [--device cuda:N|cpu] \\
        [key.path=value ...]
"""

from __future__ import annotations

import json
from pathlib import Path

from pillarnext_tpu_torch.tools import parity
from pillarnext_tpu_torch.tools import reference_mirror_mvf as tmv

CONFIG = Path(__file__).resolve().parents[2] / "pillarnext_tpu/configs/experiments/waymo_det_mvf18_aspp_iou_car.yaml"
EVAL = ["model.dtype=float32", "+model.post_processing.approx_topk=false"]
OVERFIT_STEPS = 300


def build_mirror(model_cfg: dict) -> tmv.TMVFModel:
    """The MVF mirror of ``model_cfg`` in eval mode, on the CPU."""
    rd = model_cfg["reader"]
    tasks, common = parity.tasks_and_heads(model_cfg)
    return tmv.TMVFModel(
        in_channels=rd["in_channels"], voxel_size=rd["voxel_size"], pc_range=rd["pc_range"],
        cylinder_size=rd["cylinder_size"], cylinder_range=rd["cylinder_range"],
        num_filters=tuple(rd["num_filters"]), layer_nums=tuple(rd["layer_nums"]),
        ds_layer_strides=tuple(rd["ds_layer_strides"]), ds_num_filters=tuple(rd["ds_num_filters"]),
        out_channels=rd["out_channels"], tasks=tasks, common_heads=common,
        head_stride=model_cfg["head"]["strides"][0],
    ).eval()


def run(points: int = 200_000, seed: int = 0, overfit: int = OVERFIT_STEPS, heads: bool = False,
        device="cuda:0", overrides=(), trained=None, log=print) -> dict:
    """One trained-weight parity run (``parity.trained_run``); returns its
    record and raises on a miss."""
    return parity.trained_run("MVF18", CONFIG, EVAL, build_mirror, parity.FAMILY_3D_TOLS, overfit,
                              points=points, seed=seed, heads=heads, device=device, overrides=overrides,
                              trained=trained, log=log)


def main(argv=None) -> dict:
    args = parity.parser("The port's MVF against the reference mirror at the Waymo config grid.",
                         OVERFIT_STEPS).parse_args(argv)
    rec = run(args.points, args.seed, args.overfit, args.heads, args.device, args.overrides,
              log=lambda s: print(s, flush=True))
    print(json.dumps(parity.printable(rec)), flush=True)
    return rec


if __name__ == "__main__":
    main()
