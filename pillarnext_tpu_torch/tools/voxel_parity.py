#!/usr/bin/env python
"""Trained-weight detection-set parity of the port's voxel family
(voxel18_aspp) against the reference mirror at the config grid (40 x
1344^2 voxels, 6 task groups).

Counterpart of tools/voxel_parity.py for the port: the port's Trainer
overfits voxel18 as its YAML gives it (bf16 on the card) on a planted
scene of 24 objects of every class; its weights go into the port's f32
eval model (``model.dtype=float32``, ``approx_topk=false``) and, through
``state_dict_to_reference``, into the port's copy of the voxel mirror
(``reference_mirror3d.TVoxelModel``: mean VFE, explicit gather-based
spconv semantics, reference det3d sparse_resnet3d.py:9-72 /
voxel_encoder.py:12-87), which runs in full f32 on the device with its
rulebooks on the host.  Both full pipelines run on the scene; the port's
detections (``AdaptivePredictor.predict``, as served) must equal the
mirror's exactly: the same count (more than 0), every detection matched
with its label, boxes within 5e-2 and scores within 5e-3 (the 3-D stack
compounds f32 noise).  ``--heads`` compares the raw head maps instead.

    python -m pillarnext_tpu_torch.tools.voxel_parity [--points 200000] \\
        [--seed 0] [--overfit 300] [--heads] [--device cuda:N|cpu] \\
        [key.path=value ...]

Keep ``--overfit`` at ~300 at full scale: BatchNorm's momentum is 0.99,
so after 30-100 steps the running statistics still carry much of their
init and the eval pass suppresses every peak the train pass sees.
"""

from __future__ import annotations

import json
from pathlib import Path


from pillarnext_tpu_torch.tools import parity
from pillarnext_tpu_torch.tools import reference_mirror3d as tm3

CONFIG = Path(__file__).resolve().parents[2] / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
EVAL = ["model.dtype=float32", "+model.post_processing.approx_topk=false"]
OVERFIT_STEPS = 300


def build_mirror(model_cfg: dict) -> tm3.TVoxelModel:
    """The voxel mirror of ``model_cfg`` in eval mode, on the CPU."""
    rd, bb = model_cfg["reader"], model_cfg["backbone"]
    tasks, common = parity.tasks_and_heads(model_cfg)
    return tm3.TVoxelModel(
        num_input_features=rd.get("num_input_features", 5), voxel_size=rd["voxel_size"], pc_range=rd["pc_range"],
        bb_filters=tuple(bb["ds_num_filters"]), bb_strides=tuple(bb["ds_layer_strides"]),
        bb_layer_nums=tuple(bb["layer_nums"]), out_channels=bb["out_channels"], tasks=tasks,
        common_heads=common, head_stride=model_cfg["head"]["strides"][0],
    ).eval()


def run(points: int = 200_000, seed: int = 0, overfit: int = OVERFIT_STEPS, heads: bool = False,
        device="cuda:0", overrides=(), trained=None, log=print) -> dict:
    """One trained-weight parity run (``parity.trained_run``); returns its
    record and raises on a miss."""
    return parity.trained_run("VOXEL18", CONFIG, EVAL, build_mirror, parity.FAMILY_3D_TOLS, overfit,
                              points=points, seed=seed, heads=heads, device=device, overrides=overrides,
                              trained=trained, log=log)


def main(argv=None) -> dict:
    args = parity.parser("The port's voxel18 against the reference mirror at the config grid.",
                         OVERFIT_STEPS).parse_args(argv)
    rec = run(args.points, args.seed, args.overfit, args.heads, args.device, args.overrides,
              log=lambda s: print(s, flush=True))
    print(json.dumps(parity.printable(rec)), flush=True)
    return rec


if __name__ == "__main__":
    main()
