"""The reference's CenterPoint training loss and its optimizer step.

det3d's CenterHead.loss (penalty-reduced focal loss on the heatmap, masked
L1 on the box code at object centres weighted by ``code_weights``, and the
DIoU regression loss of ``with_reg_iou``), summed over task groups, and
the optimizer the JAX package and the program run: the global-norm clip,
then AdamW (decoupled weight decay on every parameter) with the cosine
one-cycle schedule.  Plain float32 PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def gather(feat_nchw: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) at flat indices (B, M) -> (B, M, C)."""
    b, c = feat_nchw.shape[:2]
    flat = feat_nchw.reshape(b, c, -1).transpose(1, 2)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))


def focal_loss(hm: torch.Tensor, target: torch.Tensor, ind, mask, cat) -> torch.Tensor:
    """CornerNet's focal loss; ``hm`` (B, C, H, W) after sigmoid and clamp,
    ``target`` (B, H, W, C) as the assigner writes it."""
    target = target.permute(0, 3, 1, 2)
    m = mask.float()
    neg = (hm ** 2 * (1 - target) ** 4 * torch.log(1 - hm)).sum()
    pos_pred = torch.gather(gather(hm, ind), 2, cat.long()[..., None])[..., 0]
    num = m.sum()
    pos = (torch.log(pos_pred) * (1 - pos_pred) ** 2 * m).sum()
    return -(pos + neg) / num if num > 0 else -neg


def diou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Row-aligned 3-D DIoU of [x, y, z, dx, dy, dz, yaw] boxes, the boxes
    taken axis-aligned (det3d's bbox3d_overlaps_diou ignores the yaw)."""
    def extent(b):
        return b[:, :3] - b[:, 3:6] / 2, b[:, :3] + b[:, 3:6] / 2
    (p0, p1), (g0, g1) = extent(pred), extent(gt)
    inter = (torch.minimum(p1, g1) - torch.maximum(p0, g0)).clamp(min=0).prod(-1)
    outer = (torch.maximum(p1, g1) - torch.minimum(p0, g0)).clamp(min=0)
    union = pred[:, 3:6].prod(-1) + gt[:, 3:6].prod(-1) - inter
    centre = ((gt[:, :3] - pred[:, :3]) ** 2).sum(-1)
    return (inter / union - centre / (outer ** 2).sum(-1)).clamp(-1.0, 1.0)


def loss(preds: list, example: dict, head_cfg: dict) -> tuple[torch.Tensor, list]:
    """The total loss and each task's (hm, loc, iou_reg) parts."""
    code_w = torch.tensor(head_cfg["code_weights"], device=preds[0]["hm"].device)
    weight = float(head_cfg["weight"])
    vs, pr = head_cfg["voxel_size"], head_cfg["pc_range"]
    total, parts = 0.0, []
    for t, p in enumerate(preds):
        ind, mask = example["ind"][t], example["mask"][t]
        hm = torch.sigmoid(p["hm"]).clamp(1e-4, 1 - 1e-4)
        hm_loss = focal_loss(hm, example["hm"][t], ind, mask, example["cat"][t])
        box = torch.cat([gather(p[n], ind) for n in ("reg", "height", "dim", "vel", "rot")], -1)
        target = example["anno_box"][t]
        nan = torch.isnan(target)
        m = mask.float()[..., None]
        l1 = (torch.where(nan, 0.0, box) * m - torch.where(nan, 0.0, target) * m).abs()
        l1 = (l1 / (m.sum() + 1e-4)).sum((0, 1))
        loc = (l1 * code_w).sum()
        task = hm_loss + weight * loc
        # the predicted box at each centre, for the DIoU loss
        w = p["hm"].shape[3]
        f = float(head_cfg["out_size_factor"][t])
        reg, hei = gather(p["reg"], ind), gather(p["height"], ind)
        dim = torch.exp(gather(p["dim"], ind).clamp(-5.0, 5.0))
        rot = gather(p["rot"], ind)
        xs = ((ind % w).float()[..., None] + reg[..., :1]) * f * vs[0] + pr[0]
        ys = ((ind // w).float()[..., None] + reg[..., 1:]) * f * vs[1] + pr[1]
        boxes = torch.cat([xs, ys, hei, dim, torch.atan2(rot[..., :1], rot[..., 1:])], -1)
        d = diou(boxes.reshape(-1, 7), example["gt_boxes"][t].reshape(-1, 7)).reshape(mask.shape)
        num = mask.float().sum()
        iou_reg = ((1 - d) * mask.float()).sum() / (num + 1e-4) if num > 0 else d.new_zeros(())
        task = task + weight * iou_reg
        parts.append((hm_loss.detach(), loc.detach(), iou_reg.detach()))
        total = total + task
    return total, parts


def onecycle(total_steps: int, peak: float, pct_start: float, div_factor: float, final_div_factor: float = 1e4):
    """optax's cosine_onecycle_schedule."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [peak / div_factor, peak, peak / div_factor / final_div_factor]

    def lr(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2 * (math.cos(math.pi * frac) + 1)
        return values[-1]

    return lr


class ClipAdamW:
    """clip_by_global_norm(clip), then AdamW: ``m_hat / (sqrt(v_hat) + eps)
    + wd * p``, scaled by the schedule at the count before the update."""

    def __init__(self, params: list, lr, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01, clip=35.0):
        self.params, self.lr = params, lr
        self.b1, self.b2 = betas
        self.eps, self.wd, self.clip = eps, weight_decay, clip
        self.t = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> list:
        """One update; returns the gradients it was given, before the clip."""
        given = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        grads = given
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.clip and norm >= self.clip:
            grads = [g * (self.clip / norm) for g in grads]
        lr = self.lr(self.t)
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / (1 - self.b1 ** self.t)) / (torch.sqrt(v / (1 - self.b2 ** self.t)) + self.eps)
            p.sub_(lr * (upd + self.wd * p))
        return given
