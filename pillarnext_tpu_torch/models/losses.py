"""CenterPoint losses at static shapes.

Counterpart of pillarnext_tpu/models/losses.py:22-119: the penalty-reduced
focal loss, the masked L1 regression loss at object centres, the IoU-head
L1 loss to ``2 * IoU3D - 1`` and the DIoU regression loss.  Feature maps
are NHWC; ``ind`` holds flattened row-major (y * W + x) centre indices
(data/assign.py); every target has ``max_objs`` slots with a validity
``mask``.

Every normaliser (the positive count of each loss) is a count over the
global batch: under JAX's global-view ``jit`` on a data mesh
(pillarnext_tpu/parallel/mesh.py) ``maskf.sum()`` sums every device's
rows, so with several ranks (parallel/) each count is all-reduced and a
rank's loss is its local sum over the global count.  The ranks' losses
then add up to JAX's loss, and the sum of their gradients (one all-reduce
in train_state.train_step) is its gradient; per-rank normalisers with
averaged gradients would differ whenever the ranks hold different numbers
of objects.  Without a process group the counts are local, as before.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.core import torch_box_ops


def gather_feature_map(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) map gathered at flat indices (B, M) -> (B, M, C)."""
    b, h, w, c = feat.shape
    return torch.gather(feat.reshape(b, h * w, c), 1, ind.long()[..., None].expand(-1, -1, c))


def fast_focal_loss(out, target, ind, mask, cat) -> torch.Tensor:
    """CornerNet penalty-reduced focal loss.  ``out``/``target`` (B, H, W,
    C), ``out`` already sigmoid-clamped; ``ind``/``mask``/``cat`` (B, M)."""
    maskf = mask.float()
    neg_weights = torch.pow(1.0 - target, 4)
    neg_loss = (torch.square(out) * neg_weights * torch.log(1.0 - out)).sum()
    pos_pred_pix = gather_feature_map(out, ind)
    pos_pred = torch.gather(pos_pred_pix, 2, cat.long()[..., None])[..., 0]
    num_pos = parallel.all_reduce_sum(maskf.sum())  # global count: see the module docstring
    pos_loss = (torch.log(pos_pred) * torch.square(1.0 - pos_pred) * maskf).sum()
    return torch.where(
        num_pos > 0, -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0), -neg_loss
    )


def reg_loss(pred, mask, target) -> torch.Tensor:
    """Masked L1 at object centres normalised by the positive count: the
    per-dimension (D,) loss.  ``pred`` (B, M, D) is already gathered at the
    centres.  NaN target slots (the velocity of pasted objects) are zeroed
    on BOTH sides, so they give zero loss and zero gradient."""
    maskf = mask.float()[..., None]
    nan_slots = torch.isnan(target)
    target = torch.where(nan_slots, 0.0, target)
    pred = torch.where(nan_slots, 0.0, pred)
    loss = torch.abs(pred * maskf - target * maskf)
    loss = loss / (parallel.all_reduce_sum(maskf.sum()) + 1e-4)
    return loss.sum(dim=(0, 1))


def iou_pred_loss(iou_out, mask, ind, pred_boxes, gt_boxes) -> torch.Tensor:
    """L1 between the IoU channel and ``2 * IoU3D(pred, gt) - 1``.
    ``pred_boxes`` / ``gt_boxes`` (B, M, 7) at the same indices;
    ``pred_boxes`` must already be detached."""
    maskf = mask.float()
    pred = gather_feature_map(iou_out, ind)[..., 0]
    iou = torch_box_ops.boxes_aligned_iou3d(
        pred_boxes.reshape(-1, 7), gt_boxes.reshape(-1, 7)
    ).reshape(mask.shape)
    target = 2.0 * iou - 1.0
    num = parallel.all_reduce_sum(maskf.sum())
    loss = (torch.abs(pred - target) * maskf).sum() / (num + 1e-4)
    return torch.where(num > 0, loss, 0.0)


def iou_reg_loss(pred_boxes, mask, gt_boxes) -> torch.Tensor:
    """Mean over positives of 1 - DIoU; ``pred_boxes`` (B, M, 7) carries
    gradients."""
    maskf = mask.float()
    diou = torch_box_ops.bbox3d_overlaps_diou(
        pred_boxes.reshape(-1, 7), gt_boxes.reshape(-1, 7)
    ).reshape(mask.shape)
    num = parallel.all_reduce_sum(maskf.sum())
    loss = ((1.0 - diou) * maskf).sum() / (num + 1e-4)
    return torch.where(num > 0, loss, 0.0)
