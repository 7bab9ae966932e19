"""The reference's decode and rotated NMS (det3d CenterHead.predict and
post_processing, iou3d_nms_cuda.nms_gpu's greedy semantics).

Per task group and sample: sigmoid heatmap, centre offsets, exp of the
dims, atan2 of the rotation; the score threshold and the centre range;
the score rectified by ``score ** (1 - r) * iou ** r`` (these configs have
no IoU branch, so iou = 1); per class the ``nms_pre_max_size`` best
candidates, greedy NMS on the rotated bird's-eye IoU, at most
``nms_post_max_size`` kept.  The IoU is a polygon intersection of its own
(the corners of each box inside the other and the edges' crossings, in
angular order), in float64 on the device.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, dx, dy, yaw] -> (..., 4, 2) counter-clockwise."""
    x, y, dx, dy, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([dx, -dx, -dx, dx], -1) / 2
    ly = torch.stack([dy, dy, -dy, -dy], -1) / 2
    return torch.stack([x[..., None] + lx * c[..., None] - ly * s[..., None],
                        y[..., None] + lx * s[..., None] + ly * c[..., None]], -1)


def _inside(p: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """(..., P, 2) points in (..., 4, 2) convex CCW polygons (edges included)."""
    a = poly[..., None, :, :]
    b = torch.roll(poly, -1, dims=-2)[..., None, :, :]
    q = p[..., :, None, :]
    cross = (b[..., 0] - a[..., 0]) * (q[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (q[..., 0] - a[..., 0])
    return (cross >= -1e-9).all(-1)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Area of overlap of rotated rectangles, (..., 5) each, broadcast."""
    ca, cb = corners(a), corners(b)
    ca, cb = torch.broadcast_tensors(ca, cb)
    # edge crossings: every edge of A against every edge of B
    p, r = ca[..., :, None, :], (torch.roll(ca, -1, -2) - ca)[..., :, None, :]
    q, s = cb[..., None, :, :], (torch.roll(cb, -1, -2) - cb)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    safe = torch.where(rxs.abs() < 1e-12, torch.ones_like(rxs), rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    hit = (rxs.abs() >= 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross_pts = (p + t[..., None] * r).flatten(-3, -2)
    pts = torch.cat([ca, cb, cross_pts], -2)                                   # (..., 24, 2)
    ok = torch.cat([_inside(ca, cb), _inside(cb, ca), hit.flatten(-2)], -1)   # (..., 24)
    n = ok.sum(-1)
    centre = (pts * ok[..., None]).sum(-2) / n.clamp(min=1)[..., None]
    ang = torch.atan2(pts[..., 1] - centre[..., None, 1], pts[..., 0] - centre[..., None, 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 10.0))
    order = torch.argsort(ang, -1)
    pts = torch.gather(pts, -2, order[..., None].expand_as(pts))
    k = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(k + 1 < n[..., None], k + 1, torch.zeros_like(k))
    nxt_pts = torch.gather(pts, -2, nxt[..., None].expand_as(pts))
    valid = k < n[..., None]
    area = ((pts[..., 0] * nxt_pts[..., 1] - pts[..., 1] * nxt_pts[..., 0]) * valid).sum(-1) / 2
    return torch.where(n >= 3, area.abs(), torch.zeros_like(area))


def bev_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) -> (N, N) rotated bird's-eye IoU, float64."""
    b = boxes.double()
    inter = intersection(b[:, None, :], b[None, :, :])
    area = b[:, 2] * b[:, 3]
    return inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-12)


def nms(boxes: torch.Tensor, thresh: float, post: int) -> list:
    """Greedy NMS over score-sorted (N, 5) boxes: a box is dropped when its
    IoU with a kept box exceeds ``thresh``.  Returns kept row indices."""
    if len(boxes) == 0:
        return []
    over = (bev_iou(boxes) > thresh).cpu().numpy()
    removed = np.zeros(len(boxes), bool)
    keep = []
    for i in range(len(boxes)):
        if removed[i]:
            continue
        keep.append(i)
        if len(keep) == post:
            break
        removed |= over[i]
    return keep


def predict(preds: list, cfg: dict, head_cfg: dict) -> list:
    """Per sample: {"boxes" (n, 9), "scores" (n,), "labels" (n,)} as numpy,
    labels offset across task groups."""
    nms_cfg = cfg["nms"]
    limit = torch.tensor(cfg["post_center_limit_range"], device=preds[0]["hm"].device)
    vs, pr = cfg["voxel_size"], cfg["pc_range"]
    out = None
    offset = 0
    for t, p in enumerate(preds):
        hm = torch.sigmoid(p["hm"]).permute(0, 2, 3, 1)
        b, h, w, n_cls = hm.shape
        f = float(cfg["out_size_factor"][t])
        rows, cols = torch.meshgrid(torch.arange(h, device=hm.device), torch.arange(w, device=hm.device), indexing="ij")
        reg = p["reg"].permute(0, 2, 3, 1)
        xs = (cols + reg[..., 0]) * f * vs[0] + pr[0]
        ys = (rows + reg[..., 1]) * f * vs[1] + pr[1]
        z = p["height"][:, 0]
        dims = torch.exp(p["dim"]).permute(0, 2, 3, 1)
        vel = p["vel"].permute(0, 2, 3, 1)
        yaw = torch.atan2(p["rot"][:, 0], p["rot"][:, 1])
        boxes = torch.cat([torch.stack([xs, ys, z], -1), dims, vel, yaw[..., None]], -1).reshape(b, -1, 9)
        score, label = hm.reshape(b, -1, n_cls).max(-1)
        rect = torch.tensor(head_cfg["rectifier"][t], device=hm.device)
        if out is None:
            out = [{"boxes": [], "scores": [], "labels": []} for _ in range(b)]
        for i in range(b):
            keep = ((score[i] > cfg["score_threshold"]) & (boxes[i, :, :3] >= limit[:3]).all(-1)
                    & (boxes[i, :, :3] <= limit[3:]).all(-1))
            for c in range(n_cls):
                sel = torch.nonzero(keep & (label[i] == c))[:, 0]
                s = score[i, sel] ** (1 - rect[c])
                order = torch.argsort(-s, stable=True)[: nms_cfg["nms_pre_max_size"]]
                sel, s = sel[order], s[order]
                bx = boxes[i, sel]
                kept = nms(bx[:, [0, 1, 3, 4, 8]], nms_cfg["nms_iou_threshold"][t][c], nms_cfg["nms_post_max_size"])
                out[i]["boxes"].append(bx[kept].cpu().numpy())
                out[i]["scores"].append(s[kept].cpu().numpy())
                out[i]["labels"].append(np.full(len(kept), offset + c))
        offset += n_cls
    return [{k: np.concatenate(v) for k, v in o.items()} for o in out]
