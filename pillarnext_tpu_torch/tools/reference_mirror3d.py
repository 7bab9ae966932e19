"""The port's own PyTorch mirror of the reference VOXEL pipeline
(voxel18_aspp): the trained-weight parity oracle of the 3-D sparse family.

A copy of tests/torch_mirror3d.py (the same classes and the same
arithmetic, so on the CPU it gives that file's bits for the same
state_dict and points) whose sparse tensors keep their features on the
device of the model's weights: each conv's rulebook (``_lookup``: numpy
``searchsorted`` over the sorted linear ids) is built on the host, its
gathers and GEMMs run on the device.  It imports nothing of the JAX
package.  It mirrors the reference semantics with torch / numpy only
(explicit gather + matmul over COO active sites, the math spconv
computes, cited per class):

  reader   -- mean VFE over unique voxels (det3d/models/readers/
              voxel_encoder.py:12-87: unique integer voxel coords, the
              per-voxel mean of the raw point features, in f64 on the host)
  backbone -- SparseResNet3D (det3d/models/backbones/sparse_resnet3d.py:
              9-72): per stage a SparseConv3dBlock (SubMConv3d for stride
              1, SparseConv3d for stride 2, + BN1d(1e-3, 0.01) + ReLU) then
              SparseBasicBlock3d residual blocks; the extra z-downsample
              SparseConv3d (3,1,1)/(2,1,1)/pad 0; the SubM 1x1x1 mapping
              block; dense() + depth fold into channels
  neck/head/decode -- ``reference_mirror``'s TASPP / THead /
              reference_predict on the folded BEV

spconv semantics exactly: SubMConv3d computes outputs only at input-active
sites reading only active inputs; SparseConv3d's output set is every site
reached by >= 1 active input tap (the dilated set); BatchNorm1d runs over
the compact active rows only.

Depth fold: the reference folds (B, C, D, H, W) -> (B, C*D, H, W)
(channel-major, sparse_resnet3d.py:69-71); the port, like the JAX package,
folds depth-major ((B, H, W, D*C)).  The two are the same network up to a
fixed permutation of the neck's input channels, absorbed into trained
weights; this mirror consumes weights trained in the port, so it folds
depth-major.

Weights: torch Conv3d layout (Cout, Cin, kz, ky, kx); module names follow
the reference state_dict (backbone.blocks.{i}.{j}..., backbone.extra_conv.*,
backbone.mapping.*), as the port's voxel18 modules do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as tF


# ------------------------------------------------------------------ reader
def t_voxelize_mean(points: np.ndarray, voxel_size, pc_range, grid):
    """Reference mean VFE (voxel_encoder.py:36-72): torch.unique over integer
    (z, y, x) voxel coords of in-range points, per-voxel MEAN of the raw
    point features.

    points: (N, D) ragged valid points of ONE sample (f32).
    grid: (D, H, W) ints.
    Returns (ids sorted int64 (n,), feats torch (n, D)).
    """
    d, h, w = grid
    vs = np.asarray(voxel_size, np.float64)
    org = np.asarray(pc_range[:3], np.float64)
    f = (points[:, :3].astype(np.float64) - org) / vs
    vx = np.floor(f[:, 0]).astype(np.int64)
    vy = np.floor(f[:, 1]).astype(np.int64)
    vz = np.floor(f[:, 2]).astype(np.int64)
    ok = (vx >= 0) & (vx < w) & (vy >= 0) & (vy < h) & (vz >= 0) & (vz < d)
    lin = (vz[ok] * h + vy[ok]) * w + vx[ok]
    ids, inv = np.unique(lin, return_inverse=True)
    feats = torch.zeros((len(ids), points.shape[1]), dtype=torch.float64)
    feats.index_add_(0, torch.from_numpy(inv), torch.from_numpy(points[ok]).double())
    cnt = torch.zeros(len(ids), dtype=torch.float64)
    cnt.index_add_(0, torch.from_numpy(inv), torch.ones(int(ok.sum()), dtype=torch.float64))
    return ids, (feats / cnt[:, None]).float()


# ------------------------------------------------------ sparse tensor + ops
class SpT:
    """COO sparse tensor over one sample: sorted linear ids + row features."""

    def __init__(self, ids: np.ndarray, feats: torch.Tensor, grid):
        self.ids = ids  # (n,) int64, strictly ascending, id = (z*H + y)*W + x
        self.feats = feats  # (n, C) torch f32
        self.grid = tuple(int(g) for g in grid)  # (D, H, W)

    def coords(self):
        d, h, w = self.grid
        z, r = np.divmod(self.ids, h * w)
        y, x = np.divmod(r, w)
        return z, y, x


def _index(rows: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host row indices as a tensor on ``like``'s device."""
    return torch.from_numpy(rows).to(like.device)


def _lookup(ids: np.ndarray, query: np.ndarray, ok: np.ndarray):
    """Row index of each query id in sorted ids; -1 where absent/invalid."""
    pos = np.searchsorted(ids, np.where(ok, query, 0))
    pos = np.clip(pos, 0, len(ids) - 1)
    found = ok & (ids[pos] == np.where(ok, query, -1))
    return np.where(found, pos, -1)


def subm_conv3d(st: SpT, weight: torch.Tensor) -> SpT:
    """spconv SubMConv3d, padding k//2: outputs at the SAME active set,
    out[j] = sum over in-set neighbors of feats[nbr] @ W_tap."""
    co, ci, kz, ky, kx = weight.shape
    d, h, w = st.grid
    z, y, x = st.coords()
    out = torch.zeros((len(st.ids), co), device=st.feats.device)
    for a in range(kz):
        for b in range(ky):
            for c in range(kx):
                nz, ny, nx = z + a - kz // 2, y + b - ky // 2, x + c - kx // 2
                ok = (nz >= 0) & (nz < d) & (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
                idx = _lookup(st.ids, (nz * h + ny) * w + nx, ok)
                sel = idx >= 0
                if not sel.any():
                    continue
                wt = weight[:, :, a, b, c].T  # (ci, co)
                out[_index(np.nonzero(sel)[0], out)] += (
                    st.feats[_index(idx[sel], out)] @ wt
                )
    return SpT(st.ids, out, st.grid)


def sparse_conv3d_down(st: SpT, weight: torch.Tensor, stride, padding) -> SpT:
    """spconv SparseConv3d: out[o] = sum_tap in[o*s + tap - p] @ W_tap over
    the DILATED output active set (every site with >=1 active input tap)."""
    co, ci, kz, ky, kx = weight.shape
    d, h, w = st.grid
    sz, sy, sx = stride
    pz, py, px = padding
    od = (d + 2 * pz - kz) // sz + 1
    oh = (h + 2 * py - ky) // sy + 1
    ow = (w + 2 * px - kx) // sx + 1
    z, y, x = st.coords()

    # pass 1: the output active set (input i touches o = (i + p - tap)/s)
    touched = []
    for a in range(kz):
        zq, zr = np.divmod(z + pz - a, sz)
        for b in range(ky):
            yq, yr = np.divmod(y + py - b, sy)
            for c in range(kx):
                xq, xr = np.divmod(x + px - c, sx)
                ok = (
                    (zr == 0) & (yr == 0) & (xr == 0)
                    & (zq >= 0) & (zq < od) & (yq >= 0) & (yq < oh)
                    & (xq >= 0) & (xq < ow)
                )
                touched.append((zq[ok] * oh + yq[ok]) * ow + xq[ok])
    out_ids = np.unique(np.concatenate(touched)) if touched else np.zeros(0, np.int64)

    # pass 2: gather contributions at each output site
    oz, orr = np.divmod(out_ids, oh * ow)
    oy, ox = np.divmod(orr, ow)
    out = torch.zeros((len(out_ids), co), device=st.feats.device)
    for a in range(kz):
        nz = oz * sz + a - pz
        for b in range(ky):
            ny = oy * sy + b - py
            for c in range(kx):
                nx = ox * sx + c - px
                ok = (nz >= 0) & (nz < d) & (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
                idx = _lookup(st.ids, (nz * h + ny) * w + nx, ok)
                sel = idx >= 0
                if not sel.any():
                    continue
                wt = weight[:, :, a, b, c].T
                out[_index(np.nonzero(sel)[0], out)] += (
                    st.feats[_index(idx[sel], out)] @ wt
                )
    return SpT(out_ids, out, (od, oh, ow))


# ----------------------------------------------------------------- modules
class TSubM3d(tnn.Module):
    def __init__(self, ci, co, k=(3, 3, 3)):
        super().__init__()
        self.weight = tnn.Parameter(torch.zeros(co, ci, *k))

    def forward(self, st):
        return subm_conv3d(st, self.weight)


class TDown3d(tnn.Module):
    def __init__(self, ci, co, k=(3, 3, 3), stride=(2, 2, 2), padding=None):
        super().__init__()
        self.weight = tnn.Parameter(torch.zeros(co, ci, *k))
        self.stride = stride
        self.padding = tuple(kk // 2 for kk in k) if padding is None else padding

    def forward(self, st):
        return sparse_conv3d_down(st, self.weight, self.stride, self.padding)


def _bn_rows(norm: tnn.BatchNorm1d, st: SpT) -> SpT:
    """BatchNorm1d over compact active rows (eval: running stats affine)."""
    return SpT(st.ids, norm(st.feats), st.grid)


class TConvBlock3d(tnn.Module):
    """reference SparseConv3dBlock (sparse_conv.py:67-85): conv+BN+ReLU."""

    def __init__(self, ci, co, k=3, stride=1, subm=None):
        super().__init__()
        use_subm = stride == 1 if subm is None else subm
        kk = (k, k, k)
        self.conv = TSubM3d(ci, co, kk) if use_subm else TDown3d(
            ci, co, kk, (stride,) * 3
        )
        self.norm = tnn.BatchNorm1d(co, eps=1e-3, momentum=0.01)

    def forward(self, st):
        st = self.conv(st)
        st = _bn_rows(self.norm, st)
        return SpT(st.ids, tF.relu(st.feats), st.grid)


class TResBlock3d(tnn.Module):
    """reference SparseBasicBlock3d (sparse_conv.py:88-106)."""

    def __init__(self, ch, k=3):
        super().__init__()
        self.block1 = TConvBlock3d(ch, ch, k)
        self.conv2 = TSubM3d(ch, ch, (k, k, k))
        self.norm2 = tnn.BatchNorm1d(ch, eps=1e-3, momentum=0.01)

    def forward(self, st):
        identity = st.feats
        out = self.conv2(self.block1(st))
        f = tF.relu(self.norm2(out.feats) + identity)
        return SpT(out.ids, f, out.grid)


class TBackbone3D(tnn.Module):
    """reference SparseResNet3D (sparse_resnet3d.py:9-72), depth fold in
    THIS framework's ordering (module docstring)."""

    def __init__(self, c_in, filters, strides, layer_nums, out_ch, k=3):
        super().__init__()
        blocks, ci = [], c_in
        for f, s, n in zip(filters, strides, layer_nums):
            stage = tnn.ModuleList(
                [TConvBlock3d(ci, f, k, stride=s)]
                + [TResBlock3d(f, k) for _ in range(n)]
            )
            blocks.append(stage)
            ci = f
        self.blocks = tnn.ModuleList(blocks)
        self.extra_conv = tnn.ModuleList(
            [TDown3d(ci, ci, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
             tnn.BatchNorm1d(ci, eps=1e-3, momentum=0.01)]
        )
        self.mapping = TConvBlock3d(ci, out_ch, 1, subm=True)
        self.out_ch = out_ch

    def forward(self, st: SpT) -> torch.Tensor:
        for stage in self.blocks:
            for blk in stage:
                st = blk(st)
        st = self.extra_conv[0](st)
        st = _bn_rows(self.extra_conv[1], st)
        st = SpT(st.ids, tF.relu(st.feats), st.grid)
        st = self.mapping(st)
        # densify + fold depth into channels, FRAMEWORK ordering q = d*C + c
        d, h, w = st.grid
        c = st.feats.shape[1]
        dense = torch.zeros(d * h * w, c, device=st.feats.device)
        dense[_index(st.ids, dense)] = st.feats
        bev = dense.reshape(d, h, w, c).permute(1, 2, 0, 3).reshape(h, w, d * c)
        return bev.permute(2, 0, 1)[None]  # (1, D*C, H, W) NCHW for the neck


class TVoxelModel(tnn.Module):
    """Full voxel18_aspp mirror: mean VFE -> sparse 3-D backbone -> ASPP ->
    CenterHead (neck/head from ``reference_mirror``)."""

    def __init__(self, *, num_input_features, voxel_size, pc_range,
                 bb_filters, bb_strides, bb_layer_nums, out_channels,
                 tasks, common_heads, head_stride=2):
        super().__init__()
        from pillarnext_tpu_torch.tools import reference_mirror as tm

        self.voxel_size = voxel_size
        self.pc_range = pc_range
        gs = np.round(
            (np.asarray(pc_range[3:], np.float64) - np.asarray(pc_range[:3]))
            / np.asarray(voxel_size, np.float64)
        ).astype(int)
        self.grid = (int(gs[2]), int(gs[1]), int(gs[0]))  # (D, H, W)
        self.backbone = TBackbone3D(
            num_input_features, bb_filters, bb_strides, bb_layer_nums,
            out_channels,
        )
        depth_out = self.grid[0]
        for s in bb_strides:
            depth_out = (depth_out + 2 * 1 - 3) // s + 1  # pad-1 3x3x3 stages
        depth_out = (depth_out - 3) // 2 + 1  # extra z-down, pad 0
        bev_ch = depth_out * out_channels
        self.neck = tm.TASPP(bev_ch)
        self.head = tm.THead(bev_ch, tasks, common_heads, stride=head_stride)

    def forward(self, points: np.ndarray):
        """points: (N, D) ragged valid points of one sample."""
        ids, feats = t_voxelize_mean(points, self.voxel_size, self.pc_range, self.grid)
        feats = feats.to(self.neck.weight.device)
        bev = self.backbone(SpT(ids, feats, self.grid))
        return self.head(self.neck(bev))
