"""Multi-View Fusion reader (MVF), eval and train.

Counterpart of ``MVFFeatureNet`` (pillarnext_tpu/models/mvf_encoder.py:173-316)
and its parts ``PointNet`` (:42), ``_decorate`` (:58), ``SingleView`` (:77)
and ``_bilinear`` (:150).  The points get two views, a pillar grid over
(x, y) and a cylinder grid over (phi, z) (ops/voxelize.mvf_view_coords),
each with its compact table (one stable sort each, ops/compact.py).  Each
view decorates the points ([its 3 coordinates, the raw tail, offsets from
the cell mean, offsets from the cell centre]: 10 channels, 20 fused), runs
the PFN layer stack into its table, densifies the table (kernel 2 on a CUDA
tensor, ops/densify.py), runs a dense tower of strided ConvBlocks and
ResidualBlocks over the view grid and reads the tower's output back at
every point bilinearly.  Two point-wise MLPs fuse the points' features
with both readbacks, and a max over every coarse (H/ds, W/ds) cell gives
the dense NHWC BEV that the neck reads (the detector has no backbone).

The port's segment sums and back-gathers take ascending segment ids
(ops/scatter.py).  The pillar view's ids ascend in pillar order.  The JAX
reader runs the cylinder view over the same pillar-ordered points with
unsorted ids; here the cylinder view's decoration mean and PFN stack run
in cylinder order instead: ``compactify``'s permutation sorts the
pillar-ordered points by cylinder cell, stably, so each cell keeps its
points in pillar order.  The PFN is per point up to a per-cell max, so it
gives the same table; the cylinder features go back to pillar order for
the fusion, and the readback runs in pillar order.  The final coarse max
runs over ids that do not ascend: its forward (``scatter.segment_max``) is
exact in any order, and so is its backward, which counts ties by an
integer sum.

Dtypes follow the JAX module: the decoration is f32 and the fused features
are cast to ``dtype``; the readback's f32 weights times the tower's output
give f32, and ``PointNet`` computes in ``dtype``.

Training (``self.training``): batch statistics everywhere (masked over the
valid points in the PFN layers and the PointNets), kernel 3's max
broadcast in the PFN layers (both views run over ascending slots), each
tower block recomputed in the backward with its BatchNorm statistics
updated once (``layers.recomputed``), as JAX remats each block, and a
readback whose backward sums by kernel 3 (``_Bilinear``).  Every sum of
the step runs in one order, so two steps give the same bits.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from pillarnext_tpu_torch.models.layers import (
    BN_EPS_SPARSE,
    BN_MOMENTUM_SPARSE,
    BatchNorm,
    ConvBlock,
    ResidualBlock,
    recomputed,
)
from pillarnext_tpu_torch.models.pillar_encoder import PFNLayer
from pillarnext_tpu_torch.ops import scatter
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.densify import densify
from pillarnext_tpu_torch.ops.voxelize import ViewCoords, VoxelGrid, divide, mvf_view_coords


class PointNet(nn.Module):
    """Linear (no bias) + BN (eps 1e-3) + ReLU + mask over points, in
    ``dtype`` (mvf_encoder.py:42-55)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.linear = nn.Linear(in_ch, out_ch, bias=False)
        self.norm = BatchNorm(out_ch, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = torch.nn.functional.linear(x, self.linear.weight.to(x.dtype))
        x = torch.relu(self.norm(x, channel_dim=-1, valid=valid))
        return torch.where(valid[:, None], x, 0.0)


def _decorate(pos3, tail, u, v, valid, slot, num_segments: int, grid: VoxelGrid, plain: bool):
    """[pos3, tail, pos3 - cell mean, pos3[:, :2] - cell centre] over points
    sorted by ``slot`` (ascending) (mvf_encoder.py:58-74).  The mean's dump
    row is 0 (masked points) unless valid points overflowed the table, and
    the gather back reads it as it stands, as JAX's does."""
    mean = scatter.segment_mean(torch.where(valid[:, None], pos3, 0.0), slot, num_segments)
    f_cluster = pos3 - scatter.gather_segments(mean, slot, plain=plain)
    (su, sv), (ou, ov) = grid.voxel_size[:2], grid.pc_range[:2]
    center = torch.stack([u.float() * su + su / 2 + ou, v.float() * sv + sv / 2 + ov], dim=-1)
    return torch.cat([pos3, tail, f_cluster, pos3[:, :2] - center], dim=-1)


class _Bilinear(torch.autograd.Function):
    """Σ_k ``flat[corners[k]] * weights[k]`` over the four corners, with a
    backward that gives the same bits on every run: the forward sorts the
    4N corner rows once, stably; the backward sums each corner's weighted
    cotangent rows over that order by ``scatter.segment_sum`` (kernel 3's
    sorted sum on a CUDA tensor; its plain version with ``plain``), which
    places every corner's sum once.  Autograd's own backward of
    ``index_select`` is an ``index_add_`` whose CUDA atomics add in
    another order on each run."""

    @staticmethod
    def forward(ctx, flat, corners, weights, plain):
        out = None
        for k in range(4):
            term = flat.index_select(0, corners[k]) * weights[k]
            out = term if out is None else out + term
        if ctx.needs_input_grad[0]:
            ids, order = torch.sort(corners.reshape(-1), stable=True)
            ctx.save_for_backward(ids.int(), order, weights)
            ctx.rows, ctx.dtype, ctx.plain = flat.shape[0], flat.dtype, plain
        return out

    @staticmethod
    def backward(ctx, g):
        ids, order, weights = ctx.saved_tensors
        # corner k of point i is entry k * N + i
        rows = g.index_select(0, order % g.shape[0])
        rows.mul_(weights.reshape(-1, 1).index_select(0, order))
        grad = scatter.segment_sum(rows.to(ctx.dtype), ids, ctx.rows, plain=ctx.plain)
        return grad, None, None, None


def _bilinear(image: torch.Tensor, batch_idx: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              plain: bool = False):
    """Sample the NHWC ``image`` at fractional (u = column, v = row) per
    point, edge-clamped (mvf_encoder.py:150-170): (N, C) in the promoted
    dtype of the image and the f32 weights.  The backward is ``_Bilinear``'s
    (the same bits on every run)."""
    bsz, h, w, c = image.shape
    u0 = torch.floor(u).to(torch.int32).clamp(0, w - 1)
    u1 = (u0 + 1).clamp(0, w - 1)
    v0 = torch.floor(v).to(torch.int32).clamp(0, h - 1)
    v1 = (v0 + 1).clamp(0, h - 1)
    base = batch_idx * (h * w)
    corners = torch.stack([base + v0 * w + u0, base + v1 * w + u0, base + v0 * w + u1,
                           base + v1 * w + u1]).long()
    u0f, v0f = u0.to(u.dtype), v0.to(v.dtype)
    weights = torch.stack([(u0f + 1 - u) * (v0f + 1 - v), (u0f + 1 - u) * (v - v0f),
                           (u - u0f) * (v0f + 1 - v), (u - u0f) * (v - v0f)])[:, :, None]
    return _Bilinear.apply(image.reshape(bsz * h * w, c), corners, weights, plain)


class SingleView(nn.Module):
    """PFN stack + dense strided tower over one view grid + bilinear
    readback (mvf_encoder.py:77-147).  ``pfn.{i}`` and ``blocks.{i}.{j}``
    follow ``export_mvfnext``'s names: block 0 of a stage is its (strided)
    ConvBlock, the others its ResidualBlocks; every BN has the sparse
    constants (eps 1e-3)."""

    def __init__(self, in_ch: int, num_filters: Sequence[int], layer_nums: Sequence[int],
                 ds_layer_strides: Sequence[int], ds_num_filters: Sequence[int],
                 kernel_size: Sequence[int]):
        super().__init__()
        widths = [in_ch, *num_filters]
        self.pfn = nn.ModuleList(
            PFNLayer(widths[i], widths[i + 1], last_layer=(i == len(num_filters) - 1))
            for i in range(len(num_filters))
        )
        stages, c_in = [], widths[-1]
        for n_blocks, stride, c, k in zip(layer_nums, ds_layer_strides, ds_num_filters, kernel_size):
            stages.append(nn.ModuleList([
                ConvBlock(c_in, c, k, stride, eps=BN_EPS_SPARSE, momentum=BN_MOMENTUM_SPARSE),
                *(ResidualBlock(c, k) for _ in range(n_blocks)),
            ]))
            c_in = c
        self.blocks = nn.ModuleList(stages)
        self.ds = math.prod(int(s) for s in ds_layer_strides)

    def forward(self, feats, valid, slot, slot_id, grid_bhw, readback: ViewCoords, batch_idx,
                plain: bool = False):
        """``feats``, ``valid`` and ``slot`` (ascending) are the points in
        this view's order; ``readback`` and ``batch_idx`` give the points to
        read back at, in the caller's order.  Returns (N, C) readbacks."""
        cap = slot_id.shape[0]
        x = feats
        for i, layer in enumerate(self.pfn):
            x = layer(x, valid, slot, cap, i == len(self.pfn) - 1, plain)
        b, h, w = grid_bhw
        slot_of_dense, _ = invert_slot_map(slot_id, b * h * w)
        x = densify(x, slot_of_dense, slot_id, plain=plain).reshape(b, h, w, x.shape[-1])
        x = x.permute(0, 3, 1, 2)
        for stage in self.blocks:
            for block in stage:
                # training keeps only each block's input and recomputes the
                # block in the backward (JAX remats each block, mvf_encoder.py:115-120)
                x = recomputed(block, x) if self.training else block(x)
        u, v = divide(readback.fu, self.ds), divide(readback.fv, self.ds)
        return _bilinear(x.permute(0, 2, 3, 1), batch_idx, u, v, plain)


class MVFFeatureNet(nn.Module):
    """Points (B, N, D) + mask (B, N) -> dense (B, H/ds, W/ds, out_channels)
    NHWC, eval and train."""

    def __init__(
        self,
        in_channels: int,
        voxel_size: Sequence[float],
        pc_range: Sequence[float],
        cylinder_size: Sequence[float],
        cylinder_range: Sequence[float],
        num_filters: Sequence[int],
        layer_nums: Sequence[int],
        ds_layer_strides: Sequence[int],
        ds_num_filters: Sequence[int],
        kernel_size: Sequence[int],
        out_channels: int,
        pillar_capacity: int = 131072,
        cylinder_capacity: int = 131072,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.in_channels = int(in_channels)
        self.pillar_grid = VoxelGrid.create(voxel_size, pc_range)
        self.cylinder_grid = VoxelGrid.create(cylinder_size, cylinder_range)
        self.num_filters = tuple(int(f) for f in num_filters)
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.pillar_capacity = int(pillar_capacity)
        self.cylinder_capacity = int(cylinder_capacity)
        self.out_channels = int(out_channels)
        self.dtype = dtype
        fused = 2 * (in_channels + 5)
        view = (fused, num_filters, layer_nums, ds_layer_strides, ds_num_filters, kernel_size)
        self.pillar_view = SingleView(*view)
        self.cylinder_view = SingleView(*view)
        self.pointnet1 = PointNet(fused, ds_num_filters[-1], dtype)
        self.pointnet2 = PointNet(3 * ds_num_filters[-1], out_channels, dtype)

    @property
    def capacity(self) -> int:
        """Pillar slots per sample at the largest serving bucket (the
        buckets scale the pillar table only, as the JAX serving does)."""
        return self.pillar_capacity

    def forward(self, points, mask, capacity: int | None = None, telemetry=None, plain=False):
        """``capacity`` overrides ``pillar_capacity`` (serving buckets);
        ``telemetry`` (a dict) receives ``pillar_active`` /
        ``pillar_overflow`` / ``cylinder_active`` / ``cylinder_overflow`` as
        device scalars; ``plain`` keeps CUDA tensors on the kernels' plain
        versions."""
        b, n, d = points.shape
        if d != self.in_channels:
            raise ValueError(f"points have {d} features, expected {self.in_channels}")
        pg, cg = self.pillar_grid, self.cylinder_grid
        cap_p = min((capacity or self.pillar_capacity) * b, pg.num_pillars * b)
        cap_c = min(self.cylinder_capacity * b, cg.num_pillars * b)

        pts = points.reshape(-1, d).float()
        valid, pv, cv, cyl_pos = mvf_view_coords(pg, cg, pts[:, :3], mask.reshape(-1))
        batch_idx = torch.arange(b, dtype=torch.int32, device=points.device).repeat_interleave(n)
        pid = torch.where(valid, batch_idx * pg.num_pillars + pv.v * pg.size_x + pv.u, b * pg.num_pillars)
        order, slot_p, slot_id_p, n_p = compactify(pid, b * pg.num_pillars, cap_p)
        # from here every per-point tensor is in pillar order
        pts, valid, batch_idx, cyl_pos = pts[order], valid[order], batch_idx[order], cyl_pos[order]
        pv, cv = ViewCoords(*(t[order] for t in pv)), ViewCoords(*(t[order] for t in cv))
        cid = torch.where(valid, batch_idx * cg.num_pillars + cv.v * cg.size_x + cv.u, b * cg.num_pillars)
        # order_c: pillar order -> cylinder order, stable within a cell
        order_c, slot_c, slot_id_c, n_c = compactify(cid, b * cg.num_pillars, cap_c)
        if telemetry is not None:
            telemetry["pillar_active"] = n_p
            telemetry["pillar_overflow"] = torch.clamp(n_p - cap_p, min=0)
            telemetry["cylinder_active"] = n_c
            telemetry["cylinder_overflow"] = torch.clamp(n_c - cap_c, min=0)

        # no parameter reaches the decoration or the two view permutations, so
        # autograd records none of them: the fused features carry no gradient
        tail = pts[:, 3:]
        pillar_feats = _decorate(pts[:, :3], tail, pv.u, pv.v, valid, slot_p, cap_p + 1, pg, plain)
        valid_c = valid[order_c]
        cyl_feats = _decorate(cyl_pos[order_c], tail[order_c], cv.u[order_c], cv.v[order_c], valid_c,
                              slot_c, cap_c + 1, cg, plain)
        to_pillar = torch.empty_like(order_c).scatter_(
            0, order_c, torch.arange(order_c.shape[0], device=order_c.device))
        fused = torch.cat([pillar_feats, cyl_feats.index_select(0, to_pillar)], dim=-1)
        fused = torch.where(valid[:, None], fused, 0.0)
        if self.dtype is not None:
            fused = fused.to(self.dtype)

        pillar_view = self.pillar_view(fused, valid, slot_p, slot_id_p, (b, pg.size_y, pg.size_x),
                                       pv, batch_idx, plain)
        cylinder_view = self.cylinder_view(fused.index_select(0, order_c), valid_c, slot_c, slot_id_c,
                                           (b, cg.size_y, cg.size_x), cv, batch_idx, plain)
        pointwise = self.pointnet1(fused, valid)
        pointwise = self.pointnet2(torch.cat([pointwise, pillar_view, cylinder_view], dim=-1), valid)

        # the coarse BEV: the max over all points of each (H/ds, W/ds) cell
        ds = self.pillar_view.ds
        ho, wo = pg.size_y // ds, pg.size_x // ds
        coarse = torch.where(valid, batch_idx * (ho * wo) + (pv.v // ds) * wo + pv.u // ds, b * ho * wo)
        table = scatter.segment_max(pointwise, coarse, b * ho * wo + 1)
        return table[: b * ho * wo].reshape(b, ho, wo, self.out_channels)
