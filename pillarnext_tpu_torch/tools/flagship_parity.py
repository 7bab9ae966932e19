#!/usr/bin/env python
"""Detection-level parity of the port's flagship against the reference
mirror at the config grid.

Counterpart of tools/flagship_parity.py for the port: PillarNeXt-B
(nusc_det_pp18_aspp_iou_sp with ``model.dtype=float32``,
``masked_eval=true``, ``approx_topk=false``: 1344^2 pillars, 6 task groups,
ResNet18 depths, ASPP, 1000 / 83 NMS) on one frame through both full
pipelines with the same weights:

  mirror: the port's copy of the reference mirror (``reference_mirror``:
      torch.unique voxelization, PFN, SubM-masked dense backbone, ASPP,
      CenterHead, reference decode, the C++ oracle's rotated NMS), in full
      f32 on the device;
  port:   ``AdaptivePredictor.predict`` of the port's f32 model, as served
      (its buckets and a repair are part of what is compared).

Default (random weights): the mirror's seeded init with randomised BN
statistics goes into the port through ``state_dict_from_reference``, on
200k ``lidar_like_points``; JAX's bar: 85% matched with their labels, box
delta under 0.5, score delta under 2e-3 (~9% of random-weight detections
sit within f32 noise of the threshold, the top-k cutoff or the NMS IoU).
``--overfit STEPS``: the port's Trainer overfits the flagship as its YAML
gives it (bf16 on the card) on a planted scene of 24 objects of every
class; the weights go port -> mirror (``state_dict_to_reference``) and the
sets must be exactly equal, non-empty, boxes within 1e-2 and scores within
1e-3.  ``--heads``: the raw per-task head maps instead, which separates a
divergence in the network from one in decode and NMS.

    python -m pillarnext_tpu_torch.tools.flagship_parity [--points 200000] \\
        [--seed 0] [--overfit STEPS] [--heads] [--device cuda:N|cpu] \\
        [key.path=value ...]

It prints the counts, the matched and same-label fractions, the largest
box and score deltas, the pillars the port holds active whose PFN output
is all zero (inactive in the mirror's SubM mask), the seconds and a JSON
record, and exits non-zero on a miss.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pillarnext_tpu_torch.tools import parity
from pillarnext_tpu_torch.tools import reference_mirror as tm
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from pillarnext_tpu_torch.utils.torch_import import state_dict_from_reference

CONFIG = Path(__file__).resolve().parents[2] / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
# the f32 eval model that the mirror computes (masked SubM semantics, exact top-k)
EVAL = ["model.dtype=float32", "model.backbone.masked_eval=true", "model.post_processing.approx_topk=false"]


def build_mirror(model_cfg: dict) -> tm.TModel:
    """The mirror of ``model_cfg`` in eval mode, on the CPU (its init from
    torch's global generator).  The reference's nuScenes flagship has no
    iou branch: ``with_reg_iou`` is a loss, so the decode takes iou = 1."""
    rd, bb = model_cfg["reader"], model_cfg["backbone"]
    tasks, common = parity.tasks_and_heads(model_cfg)
    return tm.TModel(
        num_input_features=5, num_filters=tuple(rd["num_filters"]), voxel_size=rd["voxel_size"],
        pc_range=rd["pc_range"], bb_filters=tuple(bb["ds_num_filters"]), bb_strides=tuple(bb["ds_layer_strides"]),
        bb_layer_nums=tuple(bb["layer_nums"]), out_channels=bb.get("out_channels", 256), tasks=tasks,
        common_heads=common, head_stride=model_cfg["head"]["strides"][0], subm=True,
    ).eval()


def random_pair(mcfg: dict, seed: int, device) -> tuple:
    """(the port's model of ``mcfg`` on ``device``, the mirror on the CPU):
    the mirror's seeded init with randomised BN statistics, carried into
    the port through ``state_dict_from_reference``."""
    torch.manual_seed(seed)
    tmodel = build_mirror(mcfg)
    tm.randomize_bn_stats(tmodel, np.random.default_rng(seed + 1))
    model = build_model(mcfg, device=device)
    model.load_state_dict(state_dict_from_reference(tmodel.state_dict(), model), strict=True)
    return model, tmodel


def random_frame(mcfg: dict, points: int, seed: int, device) -> tuple:
    """The random-weight frame: (1, N, 5) ``lidar_like_points`` and mask
    tensors on ``device``."""
    pts, mask = lidar_like_points(1, points, mcfg["reader"]["pc_range"], seed=seed + 2)
    return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)


def mirror_inputs(points, mask, device) -> torch.Tensor:
    """The mirror's ragged (N, 1 + D) input of padded (B, N, D) tensors."""
    return tm.padded_to_ragged(points.cpu().numpy(), mask.cpu().numpy(), device)


def run(points: int = 200_000, seed: int = 0, overfit: int = 0, heads: bool = False, device="cuda:0",
        overrides=(), trained=None, log=print) -> dict:
    """One parity run; returns its record and raises on a miss.  ``trained``
    (a state_dict of the flagship trained elsewhere, and the (1, N, 5)
    points and mask tensors to hold it on) takes the place of
    ``overfit``'s own run."""
    if overfit or trained is not None:
        return parity.trained_run("FLAGSHIP", CONFIG, EVAL, build_mirror, parity.FLAGSHIP_TOLS, overfit,
                                  points=points, seed=seed, heads=heads, device=device, overrides=overrides,
                                  trained=trained, mirror_inputs=mirror_inputs, log=log)
    device = torch.device(device)
    mcfg = load_experiment(CONFIG, [*overrides, *EVAL])["model"]
    model, tmodel = random_pair(mcfg, seed, device)
    pts, mask = random_frame(mcfg, points, seed, device)
    rec = {"config": CONFIG.name, "mode": "random", "points": int(mask.sum())}
    rec.update(parity.hold("FLAGSHIP", mcfg, model, tmodel, pts, mask, mirror_inputs, trained=False,
                           heads=heads, device=device, log=log))
    return rec


def main(argv=None) -> dict:
    args = parity.parser("The port's flagship against the reference mirror at the config grid.", 0).parse_args(argv)
    rec = run(args.points, args.seed, args.overfit, args.heads, args.device, args.overrides,
              log=lambda s: print(s, flush=True))
    print(json.dumps(parity.printable(rec)), flush=True)
    return rec


if __name__ == "__main__":
    main()
