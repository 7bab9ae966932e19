"""The port's own PyTorch mirror of the MVF (multi-view fusion) reader
pipeline: the trained-weight parity oracle of the MVF family (mvf18_aspp).

A copy of tests/torch_mirror_mvf.py (the same classes and the same
arithmetic, so on the CPU it gives that file's bits for the same
state_dict and points) that runs its PFN stacks, dense view towers,
readback, point MLPs, neck and head on the device of the model's weights;
the binning and the bilinear weights stay numpy on the host.  It imports
nothing of the JAX package.  It mirrors the JAX package's documented MVF
redesign (models/mvf_encoder.py; capability parity with reference
det3d/models/readers/mvf_encoder.py:19-327) with independent torch / numpy
code:

  - parallel pillar (x/y) and cylindrical (phi/z) voxelizations with the
    reference's clamped cell coords (mvf_encoder.py:57-63) after the global
    3-D range mask (:296-303)
  - per-view decoration [pos3, raw tail, cluster(3), center(2)] -> fused 20ch
  - per-view PFN stacks (PFNLayer semantics, pillar_encoder.py:15-50)
  - per-view dense conv towers over the scatter-maxed view grid + bilinear
    readback of the downsampled maps at the point positions (the reference
    used spconv blocks; the JAX package and the port run the towers dense,
    a documented redesign, so the mirror matches them)
  - point-wise fusion MLPs (PointNet: Linear + BN1d(1e-3, 0.01) + ReLU)
  - the final coarse-BEV scatter-max over each (H/ds, W/ds) cell (a
    deterministic superset of the reference's per-fine-pillar overwrite,
    mvf_encoder.py:320-327)

Its state_dict has the keys of the port's MVF detector; neck and head are
``reference_mirror``'s TASPP / THead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from pillarnext_tpu_torch.tools.reference_mirror import TConvBlock, TPFNLayer, TResBlock


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array as a tensor on ``like``'s device."""
    return torch.from_numpy(a).to(like.device)


def _scatter_amax(x, idx, n):
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_reduce_(0, idx, x, "amax", include_self=False)
    return out


def _scatter_mean(x, idx, n):
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, idx, x)
    cnt = torch.zeros(n, dtype=x.dtype, device=x.device)
    cnt.index_add_(0, idx, torch.ones(len(idx), dtype=x.dtype, device=x.device))
    return out / cnt.clamp(min=1.0)[:, None]


def _bilinear(image, u, v):
    """Sample (H, W, C) at fractional (u=col, v=row) per point — the
    framework's _bilinear (models/mvf_encoder.py:150-176), B=1."""
    h, w, c = image.shape
    u0 = np.clip(np.floor(u).astype(np.int64), 0, w - 1)
    u1 = np.clip(u0 + 1, 0, w - 1)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, h - 1)
    v1 = np.clip(v0 + 1, 0, h - 1)
    flat = image.reshape(h * w, c)
    u0f, v0f = u0.astype(u.dtype), v0.astype(v.dtype)
    wa = _dev(((u0f + 1 - u) * (v0f + 1 - v)).astype(np.float32), flat)[:, None]
    wb = _dev(((u0f + 1 - u) * (v - v0f)).astype(np.float32), flat)[:, None]
    wc = _dev(((u - u0f) * (v0f + 1 - v)).astype(np.float32), flat)[:, None]
    wd = _dev(((u - u0f) * (v - v0f)).astype(np.float32), flat)[:, None]

    def at(vv, uu):
        return flat[_dev(vv * w + uu, flat)]

    return at(v0, u0) * wa + at(v1, u0) * wb + at(v0, u1) * wc + at(v1, u1) * wd


class TPointNet(tnn.Module):
    """Linear (no bias) + BN1d(1e-3, 0.01) + ReLU (reference
    mvf_encoder.py:19-36)."""

    def __init__(self, ci, co):
        super().__init__()
        self.linear = tnn.Linear(ci, co, bias=False)
        self.norm = tnn.BatchNorm1d(co, eps=1e-3, momentum=0.01)

    def forward(self, x):
        return tF.relu(self.norm(self.linear(x)))


class TSingleView(tnn.Module):
    """PFN stack + dense strided conv tower over one view grid + bilinear
    readback (framework SingleView, models/mvf_encoder.py:82-148)."""

    def __init__(self, in_ch, num_filters, layer_nums, strides, filters, k=3):
        super().__init__()
        pfn = []
        ci = in_ch
        for i, width in enumerate(num_filters):
            last = i == len(num_filters) - 1
            pfn.append(TPFNLayer(ci, width, last_layer=last))
            ci = width if last else width
        self.pfn = tnn.ModuleList(pfn)
        blocks, ci = [], num_filters[-1]
        for f, s, n in zip(filters, strides, layer_nums):
            stage = tnn.ModuleList(
                [TConvBlock(ci, f, k, stride=s)] + [TResBlock(f, k) for _ in range(n)]
            )
            blocks.append(stage)
            ci = f
        self.blocks = tnn.ModuleList(blocks)
        self.ds = int(np.prod(strides))

    def forward(self, feats, inv, n_cells, grid_hw, pos_uv):
        """feats (N, in_ch); inv (N,) cell index of each point;
        pos_uv (N, 2) fractional FULL-res view coords."""
        h, w = grid_hw
        x = feats
        inv_t = _dev(inv, x)
        for layer in self.pfn:
            x = layer(x, inv_t, n_cells)
        # per-cell maxes -> dense (H, W, C) view image (inv IS the dense
        # linear id v*w + u, so the scatter-max builds the image directly;
        # untouched cells stay exactly 0, like the framework's segment_max)
        table = _scatter_amax(x, inv_t, n_cells)
        img = table.reshape(h, w, -1).permute(2, 0, 1)[None]  # NCHW
        for stage in self.blocks:
            for blk in stage:
                img = blk(img)
        img = img[0].permute(1, 2, 0)  # (H', W', C)
        return _bilinear(img, pos_uv[:, 0] / self.ds, pos_uv[:, 1] / self.ds)


class TMVFModel(tnn.Module):
    """Full mvf18_aspp mirror: MVF reader -> ASPP -> CenterHead (B=1)."""

    def __init__(self, *, in_channels, voxel_size, pc_range, cylinder_size,
                 cylinder_range, num_filters, layer_nums, ds_layer_strides,
                 ds_num_filters, out_channels, tasks, common_heads,
                 head_stride=2):
        super().__init__()
        from pillarnext_tpu_torch.tools import reference_mirror as tm

        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.pc_range = np.asarray(pc_range, np.float64)
        self.cyl_size = np.asarray(cylinder_size, np.float64)
        self.cyl_range = np.asarray(cylinder_range, np.float64)
        gp = np.round((self.pc_range[3:] - self.pc_range[:3]) / self.voxel_size).astype(int)
        gc = np.round((self.cyl_range[3:] - self.cyl_range[:3]) / self.cyl_size).astype(int)
        self.grid_p = (int(gp[1]), int(gp[0]))  # (H, W): v=y, u=x
        self.grid_c = (int(gc[1]), int(gc[0]))  # (H, W): v=z, u=phi
        fused_ch = 2 * (3 + (in_channels - 3) + 5)
        reader = tnn.Module()  # namespace matches export_mvfnext's 'reader.*'
        reader.pillar_view = TSingleView(
            fused_ch, num_filters, layer_nums, ds_layer_strides, ds_num_filters,
        )
        reader.cylinder_view = TSingleView(
            fused_ch, num_filters, layer_nums, ds_layer_strides, ds_num_filters,
        )
        reader.pointnet1 = TPointNet(fused_ch, ds_num_filters[-1])
        reader.pointnet2 = TPointNet(ds_num_filters[-1] * 3, out_channels)
        self.reader = reader
        self.ds = int(np.prod(ds_layer_strides))
        self.neck = tm.TASPP(out_channels)
        self.head = tm.THead(out_channels, tasks, common_heads, stride=head_stride)

    def forward(self, points: np.ndarray):
        """points: (N, D) ragged valid points of ONE sample."""
        pc, cyl = self.pc_range, self.cyl_range
        ok = np.ones(len(points), bool)
        for ax in range(3):
            ok &= (points[:, ax] >= pc[ax]) & (points[:, ax] < pc[ax + 3])
        pts = points[ok].astype(np.float64)

        hp, wp = self.grid_p
        hc, wc = self.grid_c
        up = np.clip(np.floor((pts[:, 0] - pc[0]) / self.voxel_size[0]).astype(np.int64), 0, wp - 1)
        vp = np.clip(np.floor((pts[:, 1] - pc[1]) / self.voxel_size[1]).astype(np.int64), 0, hp - 1)
        phi = np.arctan2(pts[:, 1], pts[:, 0]) / np.pi * 180.0
        rho = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
        z = pts[:, 2]
        uc = np.clip(np.floor((phi - cyl[0]) / self.cyl_size[0]).astype(np.int64), 0, wc - 1)
        vc = np.clip(np.floor((z - cyl[1]) / self.cyl_size[1]).astype(np.int64), 0, hc - 1)

        pid = vp * wp + up
        cid = vc * wc + uc
        device = self.neck.weight.device

        def decorate(pos3, u, v, cell, n_cells, vs, rmin):
            pos3_t = torch.from_numpy(pos3.astype(np.float32)).to(device)
            cell_t = _dev(cell, pos3_t)
            mean = _scatter_mean(pos3_t, cell_t, n_cells)
            f_cluster = pos3_t - mean[cell_t]
            center = np.stack([u, v], -1).astype(np.float64) * vs[:2] + vs[:2] / 2 + rmin[:2]
            f_center = _dev((pos3[:, :2] - center).astype(np.float32), pos3_t)
            tail = _dev(pts[:, 3:].astype(np.float32), pos3_t)
            return torch.cat([pos3_t, tail, f_cluster, f_center], dim=1)

        feat_p = decorate(pts[:, :3], up, vp, pid, hp * wp, self.voxel_size, pc)
        cyl_pos = np.stack([phi, z, rho], -1)
        feat_c = decorate(cyl_pos, uc, vc, cid, hc * wc, self.cyl_size, cyl)
        fused = torch.cat([feat_p, feat_c], dim=1)

        pos_p = np.stack([(pts[:, 0] - pc[0]) / self.voxel_size[0],
                          (pts[:, 1] - pc[1]) / self.voxel_size[1]], -1)
        pos_c = np.stack([(phi - cyl[0]) / self.cyl_size[0],
                          (z - cyl[1]) / self.cyl_size[1]], -1)

        with torch.no_grad():
            pv = self.reader.pillar_view(fused, pid, hp * wp, (hp, wp), pos_p)
            cv = self.reader.cylinder_view(fused, cid, hc * wc, (hc, wc), pos_c)
            pw = self.reader.pointnet1(fused)
            pw = self.reader.pointnet2(torch.cat([pw, pv, cv], dim=1))

            ds = self.ds
            ho, wo = hp // ds, wp // ds
            coarse = (vp // ds) * wo + (up // ds)
            bev = torch.zeros((ho * wo, pw.shape[1]), device=pw.device)
            bev.index_reduce_(0, _dev(coarse, pw), pw, "amax",
                              include_self=True)  # empties stay 0 (pw >= 0)
            bev = bev.reshape(ho, wo, -1).permute(2, 0, 1)[None]
            return self.head(self.neck(bev))
