"""A moderate-scale synthetic configuration for multi-process tests.

Counterpart of pillarnext_tpu/utils/moderate.py, built on the port's own
modules, ``AssignLabel`` and ``collate``, with its own copy of the
constants.  A 384^2 pillar grid, the all-sparse training backbone
(compact tables, SubM stages, set-dilating strided downsamples) and
beam-structured scenes with thousands of active sites a sample; small
filter counts, so that a train step runs in seconds on the CPU while
every piece of the sparse machinery and its overflow telemetry does real
work.
"""

from __future__ import annotations

import numpy as np

PC_RANGE = [-49.92, -49.92, -5.0, 49.92, 49.92, 3.0]
VOXEL = [0.26, 0.26, 8.0]
TASKS = [["car"], ["pedestrian"]]
TEST_CFG = {
    "post_center_limit_range": [-55, -55, -10, 55, 55, 10],
    "max_per_img": 100,
    "nms_type": "iou3d",
    "nms": {
        "nms_pre_max_size": 128,
        "nms_post_max_size": 16,
        "nms_iou_threshold": [[0.2], [0.2]],
    },
    "score_threshold": 0.1,
    "pc_range": PC_RANGE,
    "voxel_size": VOXEL,
    "out_size_factor": [4, 4],
}


def moderate_detector(**backbone):
    """The moderate detector (float32, weights at their constructors'
    values: draw them with ``utils.weights.init_random``); ``backbone``
    overrides SparseResNet's options (``tile_stride1=True``, ...)."""
    from pillarnext_tpu_torch.models import (
        ASPPNeck,
        CenterHead,
        PillarFeatureNet,
        SingleStageDetector,
        SparseResNet,
    )

    return SingleStageDetector(
        reader=PillarFeatureNet(
            num_input_features=5,
            num_filters=(16, 16),
            voxel_size=VOXEL,
            pc_range=PC_RANGE,
            pillar_capacity=16384,
            output="sparse",
        ),
        backbone=SparseResNet(**{
            "layer_nums": (1, 1, 1, 1),
            "ds_layer_strides": (1, 2, 2, 2),
            "ds_num_filters": (16, 32, 32, 32),
            "num_input_features": 16,
            "out_channels": 32,
            "sparse_stages_train": "all",
            "stage_capacity_frac": (1.0, 1.0, 0.5, 0.25),
            **backbone,
        }),
        neck=ASPPNeck(in_channels=32),
        head=CenterHead(
            in_channels=32,
            tasks=TASKS,
            weight=0.25,
            code_weights=[1.0] * 8 + [0.2, 0.2],
            common_heads={
                "reg": (2, 2),
                "height": (1, 2),
                "dim": (3, 2),
                "rot": (2, 2),
                "vel": (2, 2),
            },
            strides=[2, 2],
            share_conv_channel=16,
            with_reg_iou=False,
            voxel_size=VOXEL,
            pc_range=PC_RANGE,
            out_size_factor=[4, 4],
            rectifier=[[0.5], [0.5]],
        ),
        post_processing=TEST_CFG,
    )


def beam_batch(batch=8, n_points=20_000, seed=0):
    """Beam-structured scenes spanning the full +-50 m range: thousands of
    occupied pillars a sample.  A numpy batch, as ``collate`` gives it
    without ``token`` and ``annotations``."""
    from pillarnext_tpu_torch.data.assign import AssignLabel
    from pillarnext_tpu_torch.data.collate import collate

    rng = np.random.default_rng(seed)
    assigner = AssignLabel(
        tasks=TASKS,
        gaussian_overlap=0.1,
        max_objs=20,
        min_radius=2,
        pc_range=PC_RANGE,
        voxel_size=VOXEL,
        out_size_factor=[4, 4],
    )
    samples = []
    for i in range(batch):
        n_boxes = 8
        boxes = np.zeros((n_boxes, 9), np.float32)
        boxes[:, :2] = rng.uniform(-40, 40, (n_boxes, 2))
        boxes[:, 2] = rng.uniform(-1, 1, n_boxes)
        boxes[:, 3:6] = rng.uniform(1.0, 4.0, (n_boxes, 3))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n_boxes)
        names = np.array(["car", "pedestrian"] * (n_boxes // 2))
        # radial beams: r in [2, 50], theta dense, clustering pillars the
        # way a spinning LiDAR does
        theta = rng.uniform(-np.pi, np.pi, n_points)
        r = 2 + 48 * rng.random(n_points) ** 2
        pts = np.zeros((n_points, 5), np.float32)
        pts[:, 0] = r * np.cos(theta)
        pts[:, 1] = r * np.sin(theta)
        pts[:, 2] = rng.uniform(-2, 1, n_points)
        pts[:, 3] = rng.uniform(0, 1, n_points)
        res = {
            "token": f"tok{i}",
            "points": pts,
            "annotations": {"gt_boxes": boxes, "gt_names": names},
        }
        samples.append(assigner(res))
    batch_d = collate(samples, max_points=n_points)
    return {k: v for k, v in batch_d.items() if k not in ("token", "annotations")}
