"""Composition root: reader -> backbone -> neck -> head.

Counterpart of ``SingleStageDetector`` (pillarnext_tpu/models/detector.py:18-52).
``model.train()`` selects the training forward of every submodule (batch
statistics, the all-sparse backbone, dense head branches); ``loss`` is the
training step's body.  An f32 model runs its forward (and so ``loss``) and
``predict`` under ``precision()``: full f32 convolutions and matmuls, not
TF32, whatever the process-wide flags say.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch import nn

# JAX's head runs circle NMS for "circle" and rotated NMS for any other
# name (centerhead.py:731-735), the reference's own "circle_nms" too; the
# port raises for a name that is neither
NMS_TYPES = ("iou3d", "circle")


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block;
    the other cuDNN flags stay as they are, and every flag is restored on
    exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = was


class SingleStageDetector(nn.Module):
    def __init__(self, reader, backbone=None, neck=None, head=None, post_processing: Any = None):
        super().__init__()
        cfg = post_processing or {}
        if cfg.get("nms_type", "iou3d") not in NMS_TYPES:
            raise ValueError(f"nms_type must be one of {NMS_TYPES}, got {cfg['nms_type']!r}")
        self.reader = reader
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.post_processing = post_processing

    def precision(self):
        """The math this model's forward, ``predict`` and backward run
        under: ``full_f32()`` for an f32 model (the reader computes in
        f32), PyTorch's flags as they stand for a bf16 one."""
        if getattr(self.reader, "dtype", None) in (None, torch.float32):
            return full_f32()
        return contextlib.nullcontext()

    def extract_feat(self, points, mask, capacity=None, telemetry=None, plain=False, tile_capacity=None):
        """(B, N, D) points + (B, N) mask -> NHWC features.  ``capacity``
        overrides the reader's table capacity and ``tile_capacity`` the
        2-D backbone's (serving's buckets); ``telemetry`` (a dict) collects
        the device-side counters; ``plain`` keeps CUDA tensors on the
        kernels' plain versions."""
        x = self.reader(points, mask, capacity=capacity, telemetry=telemetry, plain=plain)
        if self.backbone is not None:
            extra = {} if tile_capacity is None else {"tile_capacity": tile_capacity}
            x = self.backbone(x, plain=plain, telemetry=telemetry, **extra)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, points, mask, capacity=None, telemetry=None, plain=False):
        """Dense head maps, one dict per task group."""
        with self.precision():
            return self.head(self.extract_feat(points, mask, capacity, telemetry, plain))

    def loss(self, example: dict, telemetry=None, plain=False):
        """Train-mode forward + head loss -> (total loss, per-task log
        dicts) (detector.py:37-40).  ``example`` holds ``points`` (B, N, D),
        ``points_mask`` (B, N) and the per-task target lists of
        data/assign.py (hm, ind, mask, cat, anno_box, gt_boxes)."""
        if not self.training:
            raise RuntimeError("SingleStageDetector.loss needs train mode (model.train())")
        with self.precision():
            preds = self(example["points"], example["points_mask"], telemetry=telemetry, plain=plain)
            return self.head.loss(example, preds)

    def predict(self, points, mask, capacity=None, telemetry=None, plain=False, tile_capacity=None):
        """Fixed-size detections: box3d_lidar (B, D, 9), scores, label_preds,
        valid (B, D)."""
        cfg = self.post_processing
        with self.precision():
            x = self.extract_feat(points, mask, capacity, telemetry, plain, tile_capacity)
            if cfg.get("candidate_sparse_head", False):
                return self.head(x, test_cfg=cfg)
            return self.head.predict(self.head(x), cfg)
