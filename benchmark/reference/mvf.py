"""The plain reference of the MVF detector (waymo_det_mvf18_aspp_iou_car),
in float32 PyTorch.

The multi-view fusion reader as the JAX package's ``MVFFeatureNet``
computes it (pillarnext_tpu/models/mvf_encoder.py:42-316), then the ASPP
neck and the CenterHead of ``reference.model`` (imported); there is no
backbone.  Each frame's valid points (the mask and the 3-D range of
``pc_range``) get two views:

- the pillar view over (x, y) and the cylinder view over (phi, z), phi =
  atan2(y, x) in degrees; cells are floor((a - origin) / size), clamped
  into the grid;
- each view decorates its points: [its 3 coordinates (x, y, z or phi, z,
  rho), the raw tail, the offset from the cell's mean, the offset of the
  first two from the cell's centre]; the two are concatenated, 20
  channels;
- each view runs the PFN stack over the fused features (Linear, BatchNorm
  over the points, ReLU, the cell's max concatenated back; the last
  layer's cell max is the cell's row), places the rows in its dense grid,
  runs the tower (per stage a strided 3x3 ConvBlock and residual blocks,
  BatchNorm eps 1e-3, by ``F.conv2d``) and reads the tower's output back
  at every point bilinearly, at the fractional cell position over the
  tower's stride, the corners clamped into the grid;
- two PointNets (Linear, BatchNorm over the points, ReLU) fuse the points'
  features with both readbacks, and the max over every point of each
  coarse cell (the pillar cell over the stride) is the BEV.

Plain scatter operations (``torch.unique``, ``index_add_``,
``scatter_reduce``) and ``index_select`` with autograd's own backward
take the place of the program's compact tables and kernels.  Departures
from the JAX module, none of which changes a result the program can
produce: a view's cells are those its valid points occupy, with no table
capacity (the traffic overflows no table); a cell is found by the true
quotient (XLA multiplies by the reciprocal, which can move a point that
lies within an ulp of a boundary); every BatchNorm in training uses the
batch's statistics and updates no running statistic (the correctness
check compares losses, gradients and parameters); in a training forward
each tower block, the neck and each task of the head are recomputed in
the backward (``model._maybe_checkpoint``), so that the reference fits on
one card beside nothing else.

``Precision`` rounds what it rounds in ``reference.model``: every linear
and conv operand and output, each BatchNorm output and readback.  The
loss is ``reference.loss`` plus the IoU branch's: the L1 distance of the
branch at each object centre to 2 IoU3D - 1 of the box decoded there and
its ground truth (the rotated bird's-eye overlap of
``reference.postprocess``, times the height overlap, over the union).

Imports nothing of the JAX package nor of the program under test.
Parameters and buffers carry the program's names (``export_mvfnext``'s),
so one state dict loads into both.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from benchmark.reference import loss as ref_loss
from benchmark.reference.model import (ASPP, BN_EPS_SPARSE, Conv, ConvBlock, Head, Norm, PFNLayer, Precision,
                                       _maybe_checkpoint, conv2d)
from benchmark.reference.postprocess import intersection


def grid_of(size, lo_hi) -> tuple:
    """(H, W) of a view: cells of ``size`` over ``lo_hi`` (6 numbers)."""
    g = np.round((np.asarray(lo_hi[3:], np.float64) - lo_hi[:3]) / np.asarray(size, np.float64))
    return int(g[1]), int(g[0])


def cell_of(a: torch.Tensor, origin: float, size: float) -> torch.Tensor:
    """The fractional cell position (a - origin) / size, by the true quotient."""
    return (a - origin) / torch.full((), size, dtype=a.dtype, device=a.device)


def segment_max(x: torch.Tensor, inv: torch.Tensor, m: int) -> torch.Tensor:
    """(m, C): each segment's max of the rows of ``x`` (segment ``inv``)."""
    return x.new_zeros((m, x.shape[1])).scatter_reduce(0, inv[:, None].expand_as(x), x, reduce="amax",
                                                       include_self=False)


def decorate(pos3, tail, u, v, inv, m: int, size, origin) -> torch.Tensor:
    """[pos3, tail, pos3 - its cell's mean, pos3[:, :2] - its cell's centre]."""
    cnt = torch.zeros(m, device=pos3.device).index_add_(0, inv, torch.ones_like(pos3[:, 0]))
    mean = torch.zeros((m, 3), device=pos3.device).index_add_(0, inv, pos3) / cnt[:, None]
    centre = torch.stack([u.float() * size[0] + size[0] / 2 + origin[0],
                          v.float() * size[1] + size[1] / 2 + origin[1]], -1)
    return torch.cat([pos3, tail, pos3 - mean[inv], pos3[:, :2] - centre], -1)


def bilinear(x: torch.Tensor, bi, u, v) -> torch.Tensor:
    """The NCHW map ``x`` at fractional (u = column, v = row) of each
    point of frame ``bi``, the four corners clamped into the map."""
    b, c, h, w = x.shape
    flat = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    u0 = torch.floor(u).long().clamp(0, w - 1)
    v0 = torch.floor(v).long().clamp(0, h - 1)
    u1, v1 = (u0 + 1).clamp(0, w - 1), (v0 + 1).clamp(0, h - 1)
    fu, fv = u0.float(), v0.float()
    out = 0.0
    for uu, vv, wt in ((u0, v0, (fu + 1 - u) * (fv + 1 - v)), (u0, v1, (fu + 1 - u) * (v - fv)),
                       (u1, v0, (u - fu) * (fv + 1 - v)), (u1, v1, (u - fu) * (v - fv))):
        out = out + flat.index_select(0, (bi * h + vv) * w + uu) * wt[:, None]
    return out


class Residual(nn.Module):
    """ConvBlock -> conv + BN -> + identity -> ReLU, every BN eps 1e-3."""

    def __init__(self, ch: int, k: int):
        super().__init__()
        self.block1 = ConvBlock(ch, ch, k, eps=BN_EPS_SPARSE)
        self.conv2 = Conv((ch, ch, k, k))
        self.norm2 = Norm(ch, BN_EPS_SPARSE)


def tower_block(block: nn.Module, x: torch.Tensor, stride: int, prec: Precision) -> torch.Tensor:
    if isinstance(block, ConvBlock):
        k = block.conv.weight.shape[-1]
        return torch.relu(prec(block.norm(conv2d(x, block.conv, prec, stride=stride, padding=k // 2))))
    k = block.conv2.weight.shape[-1]
    y = prec(block.norm2(conv2d(tower_block(block.block1, x, 1, prec), block.conv2, prec, padding=k // 2)))
    return prec(torch.relu(y + x))


class View(nn.Module):
    """The PFN stack, the dense tower and the readback of one view."""

    def __init__(self, in_ch, num_filters, layer_nums, strides, filters, kernel_size):
        super().__init__()
        widths = [in_ch, *num_filters]
        self.pfn = nn.ModuleList(PFNLayer(widths[i], widths[i + 1], i == len(num_filters) - 1)
                                 for i in range(len(num_filters)))
        stages, c = [], widths[-1]
        for n, f, k in zip(layer_nums, filters, kernel_size):
            stages.append(nn.ModuleList([ConvBlock(c, f, k, eps=BN_EPS_SPARSE)] + [Residual(f, k) for _ in range(n)]))
            c = f
        self.blocks = nn.ModuleList(stages)
        self.strides = [int(s) for s in strides]
        self.ds = math.prod(self.strides)

    def forward(self, feats, inv, keys, shape, bi, fu, fv, prec: Precision) -> torch.Tensor:
        """``feats`` (P, 20) of the valid points, ``inv`` each point's cell
        among the sorted cell ``keys`` of the (b, h, w) grid ``shape``."""
        x, m = feats, len(keys)
        for layer in self.pfn:
            x = torch.relu(prec(layer.norm(prec(prec(x) @ prec(layer.linear.weight).t()), -1)))
            xmax = segment_max(x, inv, m)
            x = xmax if layer.last else torch.cat([x, xmax[inv]], -1)
        b, h, w = shape
        dense = x.new_zeros((b * h * w, x.shape[1])).index_copy(0, keys, x)
        x = dense.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        for stage, stride in zip(self.blocks, self.strides):
            for j, block in enumerate(stage):
                fn = functools.partial(tower_block, block, stride=stride if j == 0 else 1, prec=prec)
                x = _maybe_checkpoint(fn, x, self)
        return prec(bilinear(x, bi, fu / self.ds, fv / self.ds))


class PointNet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = Conv((cout, cin))
        self.norm = Norm(cout, BN_EPS_SPARSE)

    def forward(self, x, prec):
        return torch.relu(prec(self.norm(prec(prec(x) @ prec(self.linear.weight).t()), -1)))


class MVFReader(nn.Module):
    """Points (B, N, D) + mask (B, N) -> the NCHW BEV (B, C, H / ds, W / ds)."""

    def __init__(self, in_channels, voxel_size, pc_range, cylinder_size, cylinder_range, num_filters,
                 layer_nums, ds_layer_strides, ds_num_filters, kernel_size, out_channels):
        super().__init__()
        fused = 2 * (int(in_channels) + 5)
        view = (fused, num_filters, layer_nums, ds_layer_strides, ds_num_filters, kernel_size)
        self.pillar_view, self.cylinder_view = View(*view), View(*view)
        self.pointnet1 = PointNet(fused, ds_num_filters[-1])
        self.pointnet2 = PointNet(3 * ds_num_filters[-1], out_channels)
        self.voxel_size, self.pc_range = [float(v) for v in voxel_size], [float(v) for v in pc_range]
        self.cylinder_size = [float(v) for v in cylinder_size]
        self.cylinder_range = [float(v) for v in cylinder_range]
        self.pillar_grid = grid_of(voxel_size, pc_range)
        self.cylinder_grid = grid_of(cylinder_size, cylinder_range)

    def forward(self, points: torch.Tensor, mask: torch.Tensor, prec: Precision) -> torch.Tensor:
        b, n, d = points.shape
        pr, vs, cr, cs = self.pc_range, self.voxel_size, self.cylinder_range, self.cylinder_size
        pts = points.reshape(-1, d)
        ok = mask.reshape(-1).bool()
        for a in range(3):
            ok = ok & (pts[:, a] >= pr[a]) & (pts[:, a] < pr[a + 3])
        bi = torch.arange(b, device=points.device).repeat_interleave(n)[ok]
        pts = pts[ok]
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        phi = torch.atan2(y, x) / torch.full((), math.pi, device=x.device) * 180.0
        rho = torch.sqrt(x * x + y * y)
        views, feats = [], []
        for pos3, size, lo, (h, w) in (((x, y, z), vs, pr, self.pillar_grid),
                                       ((phi, z, rho), cs, cr, self.cylinder_grid)):
            fu, fv = cell_of(pos3[0], lo[0], size[0]), cell_of(pos3[1], lo[1], size[1])
            u = torch.floor(fu).long().clamp(0, w - 1)
            v = torch.floor(fv).long().clamp(0, h - 1)
            keys, inv = torch.unique((bi * h + v) * w + u, return_inverse=True)
            feats.append(decorate(torch.stack(pos3, -1), pts[:, 3:], u, v, inv, len(keys), size, lo))
            views.append((inv, keys, (b, h, w), fu, fv, u, v))
        fused = torch.cat(feats, -1)
        reads = [view(fused, inv, keys, shape, bi, fu, fv, prec)
                 for view, (inv, keys, shape, fu, fv, _, _) in zip((self.pillar_view, self.cylinder_view), views)]
        x = self.pointnet2(torch.cat([self.pointnet1(fused, prec), *reads], -1), prec)
        # the coarse BEV: the max over the points of each pillar cell over ds
        _, _, (_, h, w), _, _, u, v = views[0]
        ds = self.pillar_view.ds
        ho, wo = h // ds, w // ds
        bev = segment_max(x, (bi * ho + v // ds) * wo + u // ds, b * ho * wo)
        return bev.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


class MVFDetector(nn.Module):
    """MVF reader -> ASPP neck -> CenterHead, from the experiment's ``model`` section."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        rd, hd = model_cfg["reader"], model_cfg["head"]
        keys = ("in_channels", "voxel_size", "pc_range", "cylinder_size", "cylinder_range", "num_filters",
                "layer_nums", "ds_layer_strides", "ds_num_filters", "kernel_size", "out_channels")
        self.reader = MVFReader(**{k: rd[k] for k in keys})
        ch = int(rd["out_channels"])
        self.neck = ASPP(ch)
        self.head = Head(ch, hd["tasks"], hd["common_heads"], int(hd["strides"][0]),
                         int(hd.get("share_conv_channel", 64)))

    def forward(self, points, mask, prec: Precision | None = None):
        """Per-task dicts of NCHW maps."""
        prec = prec or Precision()
        return self.head(self.neck(self.reader(points, mask, prec), prec), prec)


def centre_boxes(p: dict, ind: torch.Tensor, head_cfg: dict, task: int) -> torch.Tensor:
    """(B, M, 7) [x, y, z, dx, dy, dz, yaw] decoded at the centre indices."""
    vs, pr, f = head_cfg["voxel_size"], head_cfg["pc_range"], float(head_cfg["out_size_factor"][task])
    w = p["hm"].shape[3]
    reg, hei, rot = (ref_loss.gather(p[n], ind) for n in ("reg", "height", "rot"))
    dim = torch.exp(ref_loss.gather(p["dim"], ind).clamp(-5.0, 5.0))
    xs = ((ind % w).float()[..., None] + reg[..., :1]) * f * vs[0] + pr[0]
    ys = ((ind // w).float()[..., None] + reg[..., 1:]) * f * vs[1] + pr[1]
    return torch.cat([xs, ys, hei, dim, torch.atan2(rot[..., :1], rot[..., 1:])], -1)


def iou3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-aligned rotated 3-D IoU of (N, 7) boxes, in float64."""
    a, b = a.double(), b.double()
    bev = intersection(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]])
    top = torch.minimum(a[:, 2] + a[:, 5] / 2, b[:, 2] + b[:, 5] / 2)
    bottom = torch.maximum(a[:, 2] - a[:, 5] / 2, b[:, 2] - b[:, 5] / 2)
    inter = bev * (top - bottom).clamp(min=0)
    union = a[:, 3:6].prod(-1) + b[:, 3:6].prod(-1) - inter
    return inter / union.clamp(min=1e-6)


def loss(preds: list, example: dict, head_cfg: dict) -> torch.Tensor:
    """``reference.loss``'s total, plus each task's IoU-branch loss when
    the head has an ``iou`` branch."""
    total, _ = ref_loss.loss(preds, example, head_cfg)
    if "iou" not in head_cfg["common_heads"]:
        return total
    for t, p in enumerate(preds):
        ind, m = example["ind"][t], example["mask"][t].float()
        with torch.no_grad():
            boxes = centre_boxes(p, ind, head_cfg, t).reshape(-1, 7)
            target = (2 * iou3d(boxes, example["gt_boxes"][t].reshape(-1, 7)) - 1).float().reshape(m.shape)
        pred = ref_loss.gather(p["iou"], ind)[..., 0]
        num = m.sum()
        if num > 0:
            total = total + ((pred - target).abs() * m).sum() / (num + 1e-4)
    return total
