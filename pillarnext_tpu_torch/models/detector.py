"""Composition root: reader -> backbone -> neck -> head.

Counterpart of ``SingleStageDetector`` (pillarnext_tpu/models/detector.py:18-52), eval.
"""

from __future__ import annotations

from typing import Any

from torch import nn

_PORTED_NMS = ("iou3d",)


class SingleStageDetector(nn.Module):
    def __init__(self, reader, backbone=None, neck=None, head=None, post_processing: Any = None):
        super().__init__()
        cfg = post_processing or {}
        if cfg.get("nms_type", "iou3d") not in _PORTED_NMS:
            raise NotImplementedError(
                f"nms_type={cfg['nms_type']!r} not ported yet (iou3d only), see ROADMAP"
            )
        if cfg.get("approx_topk", False):
            raise NotImplementedError("approx_topk not ported yet, see ROADMAP")
        self.reader = reader
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.post_processing = post_processing

    def extract_feat(self, points, mask, capacity=None, telemetry=None, plain=False):
        """(B, N, D) points + (B, N) mask -> NHWC features.  ``capacity``
        overrides the reader's table capacity; ``telemetry`` (a dict)
        collects the reader's device-side counters; ``plain`` keeps CUDA
        tensors on the kernels' plain versions."""
        x = self.reader(points, mask, capacity=capacity, telemetry=telemetry, plain=plain)
        if self.backbone is not None:
            x = self.backbone(x, plain=plain)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, points, mask, capacity=None, telemetry=None, plain=False):
        """Dense head maps, one dict per task group."""
        return self.head(self.extract_feat(points, mask, capacity, telemetry, plain))

    def predict(self, points, mask, capacity=None, telemetry=None, plain=False):
        """Fixed-size detections: box3d_lidar (B, D, 9), scores, label_preds,
        valid (B, D)."""
        cfg = self.post_processing
        x = self.extract_feat(points, mask, capacity, telemetry, plain)
        if cfg.get("candidate_sparse_head", False):
            return self.head(x, test_cfg=cfg)
        return self.head.predict(self.head(x), cfg)
