"""The port's own full-pipeline PyTorch mirror of the reference model.

A copy of tests/torch_mirror.py (the same classes and the same arithmetic,
so on the CPU it gives that file's bits for the same state_dict and
points) that takes a device: on the card its reader, its dense backbone,
neck and head run there, so a 1344^2 frame takes seconds.  It imports
nothing of the JAX package; its rotated NMS is the port's C++ oracle
(``core/native_geometry.py``, ``core/native/geometry.cpp``).  It mirrors
the reference det3d wiring, cited per class:

- ``torch_scatter.scatter_max/mean``  -> ``torch.Tensor.scatter_reduce``
- spconv SubM/Sparse convs            -> dense convs re-masked to the
  active set (``TBackbone(subm=True)``)
- ``iou3d_nms_cuda.nms_gpu``          -> ``native_geometry.rotated_nms``
  (the C++ oracle of iou3d_cpu.cpp / iou3d_nms_kernel.cu:104-225)

The mirror's ``state_dict()`` keys follow the reference checkpoint schema
(``reader.pfn_layers.N.linear.weight`` ...), as the port's modules do;
``utils/torch_import.state_dict_from_reference`` and
``state_dict_to_reference`` carry weights between the two.  Run its
forward under ``models/detector.full_f32()`` on the card: cuDNN allows
TF32 by default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from pillarnext_tpu_torch.core import native_geometry


# --------------------------------------------------------------- scatter ops
def _scatter(src: torch.Tensor, index: torch.Tensor, n: int, reduce: str):
    """torch_scatter.scatter_{mean,max} stand-in via core scatter_reduce."""
    out = torch.zeros((n, src.shape[1]), dtype=src.dtype, device=src.device)
    return out.scatter_reduce(
        0, index[:, None].expand_as(src), src, reduce=reduce, include_self=False
    )


# ------------------------------------------------------------------- reader
class TPFNLayer(tnn.Module):
    """reference PFNLayer (pillar_encoder.py:15-50): Linear(no bias) +
    BN1d(eps 1e-3, mom 0.01) + ReLU, per-pillar max concat unless last."""

    def __init__(self, in_ch, out_ch, last_layer=False):
        super().__init__()
        self.last_vfe = last_layer
        units = out_ch if last_layer else out_ch // 2
        self.linear = tnn.Linear(in_ch, units, bias=False)
        self.norm = tnn.BatchNorm1d(units, eps=1e-3, momentum=0.01)

    def forward(self, x, unq_inv, n_pillars):
        x = tF.relu(self.norm(self.linear(x)))
        x_max = _scatter(x, unq_inv, n_pillars, "amax")[unq_inv]
        if self.last_vfe:
            return x_max
        return torch.cat([x, x_max], dim=1)


class TReader(tnn.Module):
    """reference PillarFeatureNet + PillarNet (pillar_encoder.py:53-182):
    dynamic voxelization via torch.unique, +5 decoration dims, PFN stack,
    final per-pillar scatter_max; returns a dense NCHW BEV image (the
    backbone's SparseConvTensor.dense() view, sparse_resnet.py:61-68)."""

    def __init__(self, num_input_features, num_filters, voxel_size, pc_range):
        super().__init__()
        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.pc_range = np.asarray(pc_range, np.float64)
        widths = [num_input_features + 5] + list(num_filters)
        self.pfn_layers = tnn.ModuleList(
            TPFNLayer(widths[i], widths[i + 1], last_layer=(i == len(widths) - 2))
            for i in range(len(widths) - 1)
        )

    def forward(self, points: torch.Tensor):
        """points: (N, 1+D) ragged batch, columns [batch, x, y, z, feat...]."""
        grid = np.round(
            (self.pc_range[3:] - self.pc_range[:3]) / self.voxel_size
        ).astype(np.int64)
        vs = torch.tensor(self.voxel_size, dtype=points.dtype, device=points.device)
        pr = torch.tensor(self.pc_range, dtype=points.dtype, device=points.device)

        coords_f = (points[:, 1:4] - pr[:3]) / vs
        keep = (
            (coords_f[:, 0] >= 0)
            & (coords_f[:, 0] < grid[0])
            & (coords_f[:, 1] >= 0)
            & (coords_f[:, 1] < grid[1])
        )
        points, coords = points[keep], coords_f[keep].long()

        pidx = torch.cat([points[:, 0:1].long(), coords[:, :2]], dim=1)
        unq, unq_inv = torch.unique(pidx, return_inverse=True, dim=0)
        n_pillars = unq.shape[0]

        mean_xyz = _scatter(points[:, 1:4], unq_inv, n_pillars, "mean")
        f_cluster = points[:, 1:4] - mean_xyz[unq_inv]
        f_center = points[:, 1:3] - (
            coords[:, :2].to(points.dtype) * vs[:2] + vs[:2] / 2 + pr[:2]
        )
        feats = torch.cat([points[:, 1:], f_cluster, f_center], dim=1)

        for pfn in self.pfn_layers:
            feats = pfn(feats, unq_inv, n_pillars)
        pillar_feats = _scatter(feats, unq_inv, n_pillars, "amax")

        b = int(unq[:, 0].max()) + 1 if n_pillars else 1
        h, w = int(grid[1]), int(grid[0])
        dense = torch.zeros((b, pillar_feats.shape[1], h, w), dtype=points.dtype, device=points.device)
        dense[unq[:, 0], :, unq[:, 2], unq[:, 1]] = pillar_feats
        return dense


# ----------------------------------------------------------------- backbone
class TConvBlock(tnn.Module):
    """reference SparseConvBlock (sparse_conv.py:16-39), dense stand-in."""

    def __init__(self, cin, cout, k=3, stride=1, eps=1e-3, mom=0.01):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.norm = tnn.BatchNorm2d(cout, eps=eps, momentum=mom)

    def forward(self, x):
        return tF.relu(self.norm(self.conv(x)))


class TResBlock(tnn.Module):
    """reference SparseBasicBlock (sparse_conv.py:42-63): block1(conv-bn-relu),
    conv2-bn2, +identity, relu.  With ``mask`` the inner activation is
    re-masked too (SubM computes only at active sites)."""

    def __init__(self, ch, k=3):
        super().__init__()
        self.block1 = TConvBlock(ch, ch, k)
        self.conv2 = tnn.Conv2d(ch, ch, k, padding=k // 2, bias=False)
        self.norm2 = tnn.BatchNorm2d(ch, eps=1e-3, momentum=0.01)

    def forward(self, x, mask=None):
        t = self.block1(x)
        if mask is not None:
            t = t * mask
        y = tF.relu(self.norm2(self.conv2(t)) + x)
        return y if mask is None else y * mask


class TBackbone(tnn.Module):
    """reference SparseResNet (sparse_resnet.py:10-68).  ``subm=True``
    replicates spconv's active-set semantics densely: every block's output
    is re-masked to the active set (SubM blocks preserve it; strided
    SparseConv dilates it by the kernel window) — the oracle for our
    sparse/masked-dense backbone paths."""

    def __init__(self, c_in, filters, strides, layer_nums, out_ch, subm=False):
        super().__init__()
        self.subm = subm
        self.strides = list(strides)
        blocks = []
        cin = c_in
        for f, s, n in zip(filters, strides, layer_nums):
            stage = tnn.ModuleList(
                [TConvBlock(cin, f, stride=s)] + [TResBlock(f) for _ in range(n)]
            )
            blocks.append(stage)
            cin = f
        self.blocks = tnn.ModuleList(blocks)
        self.mapping = tnn.Sequential(
            tnn.Conv2d(cin, out_ch, 1, bias=False),
            tnn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.01),
            tnn.ReLU(),
        )

    def forward(self, x):
        if not self.subm:
            for stage in self.blocks:
                for b in stage:
                    x = b(x)
            return self.mapping(x)
        mask = (x.abs().sum(1, keepdim=True) > 0).float()
        for stage, s in zip(self.blocks, self.strides):
            if s > 1:
                mask = tF.max_pool2d(mask, 3, stride=s, padding=1)
            for b in stage:
                x = b(x, mask) if isinstance(b, TResBlock) else b(x) * mask
        return self.mapping(x) * mask


# --------------------------------------------------------------------- neck
class TDenseBasic(tnn.Module):
    """reference dense BasicBlock (conv.py:32-51): two full ConvBlocks +
    identity + relu, torch-default BN (eps 1e-5, mom 0.1)."""

    def __init__(self, ch):
        super().__init__()
        self.block1 = TConvBlock(ch, ch, eps=1e-5, mom=0.1)
        self.block2 = TConvBlock(ch, ch, eps=1e-5, mom=0.1)

    def forward(self, x):
        return tF.relu(self.block2(self.block1(x)) + x)


class TASPP(tnn.Module):
    """reference ASPPNeck (aspp.py:8-40): pre residual block, then
    [identity, 1x1, shared 3x3 weight at dilations 1/6/12/18] concat, 1x1."""

    def __init__(self, ch):
        super().__init__()
        self.pre_conv = TDenseBasic(ch)
        self.conv1x1 = tnn.Conv2d(ch, ch, 1, bias=False)
        self.weight = tnn.Parameter(torch.randn(ch, ch, 3, 3) * 0.05)
        self.post_conv = TConvBlock(ch * 6, ch, k=1, eps=1e-5, mom=0.1)

    def forward(self, x):
        x = self.pre_conv(x)
        branches = [x, self.conv1x1(x)] + [
            tF.conv2d(x, self.weight, padding=d, dilation=d) for d in (1, 6, 12, 18)
        ]
        return self.post_conv(torch.cat(branches, dim=1))


# --------------------------------------------------------------------- head
class THead(tnn.Module):
    """reference CenterHead + SepHead (centerhead.py:12-136): shared 3x3
    conv, per task a ConvTranspose deblock then per-branch [conv-bn-relu,
    conv] stacks; hm bias -2.19."""

    def __init__(self, ch, tasks, common, head_conv=64, stride=2):
        super().__init__()
        self.tasks_spec = [list(t) for t in tasks]
        self.common = dict(common)
        self.stride = stride
        self.shared_conv = tnn.Sequential(
            tnn.Conv2d(ch, head_conv, 3, padding=1, bias=True),
            tnn.BatchNorm2d(head_conv),
            tnn.ReLU(),
        )
        self.tasks = tnn.ModuleList()
        for task in tasks:
            mod = tnn.Module()
            deblock = tnn.Module()
            deblock.conv = tnn.ConvTranspose2d(
                head_conv, head_conv, stride, stride=stride, bias=False
            )
            deblock.norm = tnn.BatchNorm2d(head_conv)
            mod.deblock = deblock
            branches = dict(common)
            branches["hm"] = (len(task), 2)
            for name, (n_out, n_conv) in branches.items():
                layers = []
                for _ in range(n_conv - 1):
                    layers += [
                        tnn.Conv2d(head_conv, head_conv, 3, padding=1, bias=True),
                        tnn.BatchNorm2d(head_conv),
                        tnn.ReLU(),
                    ]
                final = tnn.Conv2d(head_conv, n_out, 3, padding=1, bias=True)
                if name == "hm":
                    tnn.init.constant_(final.bias, -2.19)
                layers.append(final)
                setattr(mod, name, tnn.Sequential(*layers))
            self.tasks.append(mod)

    def forward(self, x):
        x = self.shared_conv(x)
        outs = []
        for task, mod in zip(self.tasks_spec, self.tasks):
            h = tF.relu(mod.deblock.norm(mod.deblock.conv(x)))
            branches = dict(self.common)
            branches["hm"] = (len(task), 2)
            outs.append({name: getattr(mod, name)(h) for name in branches})
        return outs


# -------------------------------------------------------------- full model
class TModel(tnn.Module):
    """Full reference pipeline mirror: reader -> backbone -> neck -> head."""

    def __init__(
        self,
        *,
        num_input_features,
        num_filters,
        voxel_size,
        pc_range,
        bb_filters,
        bb_strides,
        bb_layer_nums,
        out_channels,
        tasks,
        common_heads,
        head_stride=2,
        subm=False,
    ):
        super().__init__()
        self.reader = TReader(num_input_features, num_filters, voxel_size, pc_range)
        self.backbone = TBackbone(
            num_filters[-1], bb_filters, bb_strides, bb_layer_nums, out_channels,
            subm=subm,
        )
        self.neck = TASPP(out_channels)
        self.head = THead(out_channels, tasks, common_heads, stride=head_stride)

    def forward(self, points):
        return self.head(self.neck(self.backbone(self.reader(points))))


def randomize_bn_stats(model: tnn.Module, rng: np.random.Generator):
    for m in model.modules():
        if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d)):
            n = int(m.num_features)
            with torch.no_grad():
                m.running_mean.copy_(
                    torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32))
                )
                m.running_var.copy_(
                    torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
                )


def padded_to_ragged(points: np.ndarray, mask: np.ndarray, device="cpu") -> torch.Tensor:
    """(B, N, D) padded + (B, N) mask -> reference ragged (sumN, 1+D) with a
    leading batch-index column (collate.py:16-22), on ``device``."""
    rows = []
    for b in range(points.shape[0]):
        p = points[b][mask[b].astype(bool)]
        rows.append(np.concatenate([np.full((len(p), 1), b, p.dtype), p], axis=1))
    return torch.from_numpy(np.concatenate(rows, axis=0).astype(np.float32)).to(device)


# ------------------------------------------------------- reference decode
def reference_predict(preds_tasks, test_cfg, rectifier, num_classes):
    """NumPy mirror of CenterHead.predict + post_processing
    (centerhead.py:231-384): sigmoid/exp/atan2 decode to world-frame 9-dim
    boxes, score+range masks, IoU score rectification, per-class rotated NMS
    (via the C++ oracle = the CUDA kernel's greedy semantics), merge with
    label offsetting.

    preds_tasks: list (per task) of dicts name -> np.ndarray NCHW.
    Returns: list (per sample) of dicts box3d_lidar/scores/label_preds.
    """
    post_range = np.asarray(test_cfg["post_center_limit_range"], np.float32)
    out_size_factor = test_cfg["out_size_factor"]
    voxel_size = test_cfg["voxel_size"]
    pc_range = test_cfg["pc_range"]
    nms_cfg = test_cfg["nms"]

    per_task_samples = []
    batch = None
    for task_id, pd in enumerate(preds_tasks):
        nhwc = {k: np.transpose(v, (0, 2, 3, 1)) for k, v in pd.items()}
        hm = 1.0 / (1.0 + np.exp(-nhwc["hm"]))
        dim = np.exp(nhwc["dim"])
        rot = np.arctan2(nhwc["rot"][..., 0:1], nhwc["rot"][..., 1:2])
        if "iou" in nhwc:
            iou = (nhwc["iou"][..., 0] + 1.0) * 0.5
        else:
            iou = np.ones(hm.shape[:3], hm.dtype)
        batch, H, W, num_cls = hm.shape
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        xs = xs[None, ..., None] + nhwc["reg"][..., 0:1]
        ys = ys[None, ..., None] + nhwc["reg"][..., 1:2]
        xs = xs * out_size_factor[task_id] * voxel_size[0] + pc_range[0]
        ys = ys * out_size_factor[task_id] * voxel_size[1] + pc_range[1]
        boxes = np.concatenate(
            [xs, ys, nhwc["height"], dim, nhwc["vel"], rot], axis=-1
        ).reshape(batch, H * W, 9)
        hm = hm.reshape(batch, H * W, num_cls)
        iou = iou.reshape(batch, H * W)

        samples = []
        rect = np.asarray(rectifier[task_id], np.float32)
        for i in range(batch):
            scores = hm[i].max(-1)
            labels = hm[i].argmax(-1)
            mask = (
                (scores > test_cfg["score_threshold"])
                & (boxes[i][:, :3] >= post_range[:3]).all(1)
                & (boxes[i][:, :3] <= post_range[3:]).all(1)
            )
            bx, sc, lb = boxes[i][mask], scores[mask], labels[mask]
            io = np.clip(iou[i][mask], 0.0, 1.0)
            sc = sc ** (1.0 - rect[lb]) * io ** rect[lb]
            sel_b, sel_s, sel_l = [], [], []
            for cls in range(num_cls):
                cm = lb == cls
                bc, sc_c = bx[cm], sc[cm]
                order = np.argsort(-sc_c, kind="stable")[: nms_cfg["nms_pre_max_size"]]
                bev7 = bc[order][:, [0, 1, 2, 3, 4, 5, 8]]
                thr = nms_cfg["nms_iou_threshold"][task_id][cls]
                keep = native_geometry.rotated_nms(bev7, thr)
                keep = keep[: nms_cfg["nms_post_max_size"]]
                sel_b.append(bc[order][keep])
                sel_s.append(sc_c[order][keep])
                sel_l.append(np.full(len(keep), cls, np.int64))
            samples.append(
                {
                    "box3d_lidar": np.concatenate(sel_b) if sel_b else np.zeros((0, 9)),
                    "scores": np.concatenate(sel_s) if sel_s else np.zeros((0,)),
                    "label_preds": np.concatenate(sel_l) if sel_l else np.zeros((0,), np.int64),
                }
            )
        per_task_samples.append(samples)

    merged = []
    for i in range(batch):
        offset, bs, ss, ls = 0, [], [], []
        for task_id, samples in enumerate(per_task_samples):
            bs.append(samples[i]["box3d_lidar"])
            ss.append(samples[i]["scores"])
            ls.append(samples[i]["label_preds"] + offset)
            offset += num_classes[task_id]
        merged.append(
            {
                "box3d_lidar": np.concatenate(bs),
                "scores": np.concatenate(ss),
                "label_preds": np.concatenate(ls),
            }
        )
    return merged
