"""CenterPoint head: shared conv, per-task SepHeads, decode, NMS and loss.

Counterpart of ``SepHead`` / ``MergedSepHeads`` / ``CenterHead``
(pillarnext_tpu/models/centerhead.py:43-782), every option of JAX's:
``fuse_eval`` (the default), ``merge_branches``, ``merge_tasks``, and
``nms_type`` ``iou3d`` or ``circle``.  Maps are NHWC at the module boundary.  With the
post-processing config's ``candidate_sparse_head``, hm/reg/height[/iou]
run dense while dim/rot/vel are evaluated only at the selected candidates,
on zero-padded (2R+1)^2 patches of the task's deblock output — the same
values as the dense maps at those cells.  Training runs every branch dense
(batch statistics in train mode) and ``loss`` computes the per-task
CenterPoint losses (centerhead.py:474-564).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pillarnext_tpu_torch.core import nms as nms_lib
from pillarnext_tpu_torch.models import losses
from pillarnext_tpu_torch.models.layers import (
    BN_EPS_DENSE,
    BN_MOMENTUM_DENSE,
    BatchNorm,
    ConvTransposeBlock,
    conv2d,
)
from pillarnext_tpu_torch.ops.topk import exact_top_k

NEG_INF = nms_lib.NEG_INF
SPARSE_NAMES = ("dim", "rot", "vel")


class MLPHead(nn.Sequential):
    """(num_conv - 1) x [3x3 conv + BN + ReLU], then a 3x3 conv with bias
    (layers.py:353-398); indices follow the reference's Sequential
    (conv 0, BN 1, ReLU 2, ..., final conv)."""

    def __init__(self, in_ch, out_ch, num_conv, head_conv=64, final_bias=0.0, kernel_size=3):
        layers = []
        for i in range(num_conv - 1):
            layers += [
                nn.Conv2d(in_ch if i == 0 else head_conv, head_conv, kernel_size,
                          padding=kernel_size // 2, bias=True),
                BatchNorm(head_conv, BN_EPS_DENSE, BN_MOMENTUM_DENSE),
                nn.ReLU(),
            ]
        layers.append(nn.Conv2d(head_conv if num_conv > 1 else in_ch, out_ch, kernel_size,
                                padding=kernel_size // 2, bias=True))
        super().__init__(*layers)
        self.final_bias = final_bias
        with torch.no_grad():
            self[-1].bias.fill_(final_bias)

    def forward(self, x, mask=None):
        """NCHW; ``mask`` (N, 1, P, P) re-zeroes intermediate outputs outside
        the map when ``x`` holds gathered patches (the dense map's next conv
        reads zero padding there)."""
        for i in range(0, len(self) - 1, 3):
            x = torch.relu(self[i + 1](conv2d(x, self[i])))
            if mask is not None:
                x = x * mask
        return conv2d(x, self[len(self) - 1])


class SepHead(nn.Module):
    """One task group's deblock and branch bank (centerhead.py:43-214).

    Three executions of the same per-branch parameters (the reference
    schema), as JAX's SepHead runs them when every branch has two convs:
    ``merge_branches`` (training and eval) runs the branches' first convs
    as one conv 64 -> R * 64 with one BatchNorm over the concatenation,
    then each branch's final conv on its 64-channel share; ``fuse_eval``
    (eval only, JAX's default) also merges the first convs and runs ONE
    block-diagonal final conv (branch b's outputs read only channels
    ``[b * 64, b * 64 + 64)``); otherwise each branch runs on its own.
    The merged weights are assembled at apply time."""

    def __init__(self, in_ch, heads: Mapping[str, tuple], stride=1, head_conv=64,
                 init_bias=-2.19, final_kernel=3, fuse_eval: bool = True, merge_branches: bool = False):
        super().__init__()
        self.names = list(heads)
        self.head_conv = head_conv
        two_conv = all(int(nc) == 2 for _, nc in heads.values())
        self.merge_branches = merge_branches and two_conv
        self.fuse_eval = fuse_eval and not merge_branches and two_conv
        self.deblock = (
            ConvTransposeBlock(in_ch, head_conv, stride) if stride > 1 else None
        )
        branch_in = head_conv if stride > 1 else in_ch
        for name, (channels, num_conv) in heads.items():
            self.add_module(name, MLPHead(
                branch_in, channels, num_conv, head_conv,
                init_bias if name == "hm" else 0.0, final_kernel,
            ))

    def features(self, x):
        """NCHW deblock output the branches read."""
        return x if self.deblock is None else self.deblock(x)

    def branches(self, x, names, mask=None):
        """{name: NHWC map} for ``names`` over NCHW ``x``."""
        if self.merge_branches and list(names) == self.names:
            out = self._merged_branches(x)
        elif self.fuse_eval and not self.training:
            out = self._fused_branches(x, names, mask)
        else:
            out = {n: getattr(self, n)(x, mask) for n in names}
        return {n: y.permute(0, 2, 3, 1) for n, y in out.items()}

    def _merged_branches(self, x):
        """``merge_branches`` (centerhead.py:96-132): one first conv over
        every branch, one BatchNorm, each final conv on its share."""
        heads = [getattr(self, n) for n in self.names]
        first = heads[0][0]
        w1 = torch.cat([h[0].weight for h in heads]).to(x.dtype)
        b1 = torch.cat([h[0].bias for h in heads]).to(x.dtype)
        h = F.conv2d(x, w1, b1, padding=first.padding)
        h = torch.relu(BatchNorm.concatenated([hd[1] for hd in heads], h))
        hc = self.head_conv
        return {n: conv2d(h[:, i * hc:(i + 1) * hc], hd[-1])
                for i, (n, hd) in enumerate(zip(self.names, heads))}

    def _fused_branches(self, x, names, mask):
        """``fuse_eval`` (centerhead.py:157-214): the first convs as one
        conv, eval BatchNorm in JAX's order and dtype (``mul = rsqrt(var +
        eps) * scale`` in x's dtype), ReLU, ``mask`` (patches), then one
        block-diagonal final conv; the biases are added after each conv."""
        heads = [getattr(self, n) for n in names]
        dt = x.dtype
        pad = heads[0][0].padding
        norms = [h[1] for h in heads]

        def cat(tensors):
            return torch.cat(list(tensors)).to(dt)

        h = F.conv2d(x, cat(hd[0].weight for hd in heads), None, padding=pad)
        h = h + cat(hd[0].bias for hd in heads)[:, None, None]
        mean = cat(n.running_mean for n in norms)[:, None, None]
        mul = torch.rsqrt(cat(n.running_var for n in norms) + norms[0].eps) * cat(n.weight for n in norms)
        h = torch.relu((h - mean) * mul[:, None, None] + cat(n.bias for n in norms)[:, None, None])
        if mask is not None:
            h = h * mask
        # block b of the (sum c_b, R * hc * k * k) matrix is branch b's
        # final weight: reshaped, each output reads only its branch's channels
        finals = [hd[-1].weight for hd in heads]
        co = sum(w.shape[0] for w in finals)
        w2 = torch.block_diag(*(w.reshape(w.shape[0], -1) for w in finals))
        w2 = w2.reshape(co, len(finals) * finals[0].shape[1], *finals[0].shape[2:])
        y = F.conv2d(h, w2.to(dt), None, padding=pad) + cat(hd[-1].bias for hd in heads)[:, None, None]
        return dict(zip(names, torch.split(y, [w.shape[0] for w in finals], dim=1)))


class CenterHead(nn.Module):
    """Shared conv + BN + ReLU, then one SepHead per task group
    (centerhead.py:303-470).  ``merge_tasks`` (when every stride is equal
    and every branch has two convs, centerhead.py:368-386) runs every
    task's SepHead as task-batched convolutions (``MergedSepHeads``,
    centerhead.py:217-300): one ConvTranspose 64 -> T * 64 (x tiled T
    times at stride 1), one grouped conv (T groups) for every branch's
    first conv with one BatchNorm, and per branch one grouped final conv,
    hm zero-padded to the largest class count and sliced.  Both merges
    bypass the candidate-sparse head.  The parameters keep the per-task,
    per-branch reference schema in every option, so one checkpoint loads
    into each; the merged weights are assembled at apply time."""

    def __init__(
        self,
        in_channels: int,
        tasks: Sequence[Sequence[str]],
        weight: float,
        code_weights: Sequence[float],
        common_heads: Mapping[str, Sequence[int]],
        strides: Sequence[int],
        init_bias: float = -2.19,
        share_conv_channel: int = 64,
        num_hm_conv: int = 2,
        with_reg_iou: bool = False,
        merge_tasks: bool = False,
        merge_branches: bool = False,
        fuse_eval: bool = True,
        voxel_size: Sequence[float] | None = None,
        pc_range: Sequence[float] | None = None,
        out_size_factor: Sequence[int] | None = None,
        rectifier: Sequence[Sequence[float]] = (),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        # the training loss (CenterHead.loss)
        self.loss_weight = weight
        self.register_buffer("code_weights", torch.tensor(code_weights, dtype=torch.float32),
                             persistent=False)
        self.with_reg_iou = with_reg_iou
        self.voxel_size = None if voxel_size is None else [float(v) for v in voxel_size]
        self.pc_range = None if pc_range is None else [float(v) for v in pc_range]
        self.out_size_factor = None if out_size_factor is None else [int(f) for f in out_size_factor]
        self.class_names = [list(t) for t in tasks]
        self.num_classes = [len(t) for t in tasks]
        self.common_heads = {k: (int(v[0]), int(v[1])) for k, v in common_heads.items()}
        self.num_hm_conv = num_hm_conv
        self.rectifier = [list(r) for r in rectifier]
        self.merge_branches = merge_branches
        self.merge_tasks = (
            merge_tasks
            and len({int(s) for s in strides}) == 1
            and all(nc == 2 for _, nc in self.common_heads.values())
            and num_hm_conv == 2
        )
        self.stride = int(strides[0])
        hc = share_conv_channel
        self.shared_conv = nn.Sequential(
            nn.Conv2d(in_channels, hc, 3, padding=1, bias=True), BatchNorm(hc, BN_EPS_DENSE, BN_MOMENTUM_DENSE)
        )
        seps = []
        for num_cls, stride in zip(self.num_classes, strides):
            heads = dict(self.common_heads)
            heads["hm"] = (num_cls, num_hm_conv)
            seps.append(SepHead(hc, heads, int(stride), hc, init_bias,
                                fuse_eval=fuse_eval, merge_branches=merge_branches))
        self.tasks = nn.ModuleList(seps)

    def _shared(self, x):
        x = x.permute(0, 3, 1, 2)
        return torch.relu(self.shared_conv[1](conv2d(x, self.shared_conv[0])))

    def forward(self, x: torch.Tensor, test_cfg=None):
        """NHWC features -> per-task dicts of dense NHWC maps; with
        ``test_cfg`` the detections (candidate-sparse with its
        ``candidate_sparse_head``, in eval, without a merge)."""
        x = self._shared(x)
        if self.merge_tasks:
            outs = self._merged_tasks(x)
            return outs if test_cfg is None else self.predict(outs, test_cfg)
        candidate_sparse = (
            test_cfg is not None
            and not self.training
            and bool(test_cfg.get("candidate_sparse_head", False))
            and not self.merge_branches
            and all(n in self.common_heads for n in SPARSE_NAMES)
        )
        if not candidate_sparse:
            outs = [sep.branches(sep.features(x), sep.names) for sep in self.tasks]
            return outs if test_cfg is None else self.predict(outs, test_cfg)

        rad = max(nc for n, (_, nc) in self.common_heads.items() if n in SPARSE_NAMES)
        partials, feats = [], []
        for sep in self.tasks:
            feat = sep.features(x)
            partials.append(sep.branches(feat, [n for n in sep.names if n not in SPARSE_NAMES]))
            feats.append(feat.permute(0, 2, 3, 1))

        def drv_fn(task_id, idx_b):
            """dim/rot/vel (f32) at flat candidate indices by patch evaluation."""
            feat = feats[task_id]
            b, h, w, hc = feat.shape
            n = idx_b.shape[1]
            p = 2 * rad + 1
            dr, dc = np.meshgrid(np.arange(-rad, rad + 1), np.arange(-rad, rad + 1), indexing="ij")
            dr = torch.as_tensor(dr.reshape(-1), device=idx_b.device)
            dc = torch.as_tensor(dc.reshape(-1), device=idx_b.device)
            rr = (idx_b // w)[..., None] + dr
            cc = (idx_b % w)[..., None] + dc
            ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            flat = torch.where(ok, rr * w + cc, 0).reshape(b, n * p * p)
            rows = torch.gather(feat.reshape(b, h * w, hc), 1, flat[..., None].expand(-1, -1, hc))
            patches = torch.where(ok.reshape(b, n * p * p, 1), rows, 0).reshape(b * n, p, p, hc)
            pmask = ok.reshape(b * n, 1, p, p).to(patches.dtype)
            out = self.tasks[task_id].branches(patches.permute(0, 3, 1, 2), SPARSE_NAMES, pmask)
            return tuple(
                out[name][:, rad, rad, :].float().reshape(b, n, -1) for name in SPARSE_NAMES
            )

        return self.predict(partials, test_cfg, drv_fn=drv_fn)

    def _merged_tasks(self, x):
        """``MergedSepHeads`` (centerhead.py:248-300) over NCHW ``x``: the
        per-task dicts of NHWC maps."""
        seps, dt = list(self.tasks), x.dtype
        t, hc, names = len(seps), seps[0].head_conv, seps[0].names
        r = len(names)
        if self.stride > 1:
            w = torch.cat([s.deblock.conv.weight for s in seps], dim=1).to(dt)
            x = F.conv_transpose2d(x, w, stride=self.stride)
            x = torch.relu(BatchNorm.concatenated([s.deblock.norm for s in seps], x))
        else:
            x = x.repeat(1, t, 1, 1)
        firsts = [getattr(s, n) for s in seps for n in names]  # task-major
        w1 = torch.cat([f[0].weight for f in firsts]).to(dt)
        b1 = torch.cat([f[0].bias for f in firsts]).to(dt)
        h = F.conv2d(x, w1, b1, padding=1, groups=t)
        h = torch.relu(BatchNorm.concatenated([f[1] for f in firsts], h))
        hm_pad = max(self.num_classes)
        outs = [{} for _ in range(t)]
        for bi, name in enumerate(names):
            hin = torch.cat([h[:, (ti * r + bi) * hc:(ti * r + bi + 1) * hc] for ti in range(t)], dim=1)
            ws, bs = [], []
            for s in seps:
                final = getattr(s, name)[-1]
                pad = hm_pad - final.weight.shape[0] if name == "hm" else 0
                ws.append(F.pad(final.weight, (0, 0, 0, 0, 0, 0, 0, pad)))
                bs.append(F.pad(final.bias, (0, pad)))
            c_out = ws[0].shape[0]
            y = F.conv2d(hin, torch.cat(ws).to(dt), torch.cat(bs).to(dt), padding=1, groups=t)
            for ti in range(t):
                width = self.num_classes[ti] if name == "hm" else c_out
                outs[ti][name] = y[:, ti * c_out:ti * c_out + width].permute(0, 2, 3, 1)
        return outs

    # ---------------- loss ----------------

    def _decode_at_inds(self, preds, ind, task_id):
        """[x, y, z, dx, dy, dz, yaw] (B, M, 7) decoded at flat centre
        indices (centerhead.py:474-496)."""
        w = preds["hm"].shape[2]
        reg = losses.gather_feature_map(preds["reg"].float(), ind)
        hei = losses.gather_feature_map(preds["height"].float(), ind)
        dim = torch.exp(torch.clamp(losses.gather_feature_map(preds["dim"].float(), ind), -5.0, 5.0))
        rot = losses.gather_feature_map(preds["rot"].float(), ind)
        yaw = torch.atan2(rot[..., 0:1], rot[..., 1:2])
        xs = (ind % w).float()[..., None] + reg[..., 0:1]
        ys = (ind // w).float()[..., None] + reg[..., 1:2]
        factor = float(self.out_size_factor[task_id])
        xs = xs * factor * self.voxel_size[0] + self.pc_range[0]
        ys = ys * factor * self.voxel_size[1] + self.pc_range[1]
        return torch.cat([xs, ys, hei, dim, yaw], dim=-1)

    def loss(self, example, preds_dicts):
        """Total loss + per-task log dicts (centerhead.py:498-564).

        ``example`` carries per-task lists: hm (B, H, W, C), ind / mask /
        cat (B, M), anno_box (B, M, 10), gt_boxes (B, M, 7)."""
        total = 0.0
        logs = []
        with_iou = "iou" in self.common_heads
        for task_id, preds in enumerate(preds_dicts):
            hm = torch.clamp(torch.sigmoid(preds["hm"].float()), 1e-4, 1 - 1e-4)
            ind = example["ind"][task_id]
            mask = example["mask"][task_id]
            hm_loss = losses.fast_focal_loss(hm, example["hm"][task_id], ind, mask, example["cat"][task_id])
            # anno order: [reg(2), height(1), dim(3), vel(2), rot(2)]
            pred = torch.cat(
                [losses.gather_feature_map(preds[n], ind) for n in ("reg", "height", "dim", "vel", "rot")],
                dim=-1,
            ).float()
            box_loss = losses.reg_loss(pred, mask, example["anno_box"][task_id])
            loc_loss = (box_loss * self.code_weights).sum()
            task_loss = hm_loss + self.loss_weight * loc_loss
            log = {"hm_loss": hm_loss, "loc_loss": loc_loss, "loc_loss_elem": box_loss,
                   "num_positive": mask.float().sum()}
            if with_iou or self.with_reg_iou:
                boxes7 = self._decode_at_inds(preds, ind, task_id)
                gt7 = example["gt_boxes"][task_id]
                if with_iou:
                    iou_loss = losses.iou_pred_loss(preds["iou"].float(), mask, ind, boxes7.detach(), gt7)
                    task_loss = task_loss + iou_loss
                    log["iou_loss"] = iou_loss
                if self.with_reg_iou:
                    iou_reg = losses.iou_reg_loss(boxes7, mask, gt7)
                    task_loss = task_loss + self.loss_weight * iou_reg
                    log["iou_reg_loss"] = iou_reg
            log["loss"] = task_loss
            logs.append(log)
            total = total + task_loss
        return total, logs

    def predict(self, preds_dicts, test_cfg, drv_fn=None):
        """Decode + per-class NMS with fixed-size outputs
        (centerhead.py:568-782): box3d_lidar (B, D, 9), scores (B, D),
        label_preds (B, D), valid (B, D), D = sum of classes x
        nms_post_max_size.  ``drv_fn(task_id, flat_idx) -> (dim, rot, vel)``
        supplies the regression values at the candidates (default: gather
        the dense maps).  ``nms_type``: ``iou3d`` (rotated BEV IoU) or
        ``circle`` (centre distance, the lane's ``nms_iou_threshold`` its
        radius in metres).  The candidates are an exact top-k whether or
        not ``approx_topk`` is set: JAX's ``lax.approx_max_k`` returns
        exactly ``lax.top_k``'s values and indices, ties included, on the
        CPU and the GPU (it approximates only on a TPU)."""
        nms_cfg = test_cfg["nms"]
        circle = test_cfg.get("nms_type", "iou3d") == "circle"
        pre = int(nms_cfg["nms_pre_max_size"])
        post = int(nms_cfg["nms_post_max_size"])
        device = preds_dicts[0]["hm"].device
        post_range = torch.tensor(test_cfg["post_center_limit_range"], dtype=torch.float32, device=device)

        lanes = []
        for task_id, preds in enumerate(preds_dicts):
            b, h, w, num_cls = preds["hm"].shape
            hw = h * w
            hm = torch.sigmoid(preds["hm"].float()).reshape(b, hw, num_cls)
            reg = preds["reg"].float().reshape(b, hw, 2)
            hei = preds["height"].float().reshape(b, hw, 1)
            if "iou" in preds:
                iou = (preds["iou"].float().reshape(b, hw) + 1.0) * 0.5
            else:
                iou = torch.ones((b, hw), dtype=torch.float32, device=device)
            ar = torch.arange(hw, dtype=torch.float32, device=device)
            cols = ar % w
            rows = torch.floor(ar / w)
            factor = float(test_cfg["out_size_factor"][task_id])
            vs, pr = test_cfg["voxel_size"], test_cfg["pc_range"]
            xs = (cols[None, :, None] + reg[..., 0:1]) * factor * vs[0] + pr[0]
            ys = (rows[None, :, None] + reg[..., 1:2]) * factor * vs[1] + pr[1]
            pos3 = torch.cat([xs, ys, hei], dim=-1)

            scores = hm.amax(dim=-1)
            labels = hm.argmax(dim=-1)
            in_range = (pos3 >= post_range[:3]).all(-1) & (pos3 <= post_range[3:]).all(-1)
            base_valid = in_range & (scores > float(test_cfg["score_threshold"]))
            rect = torch.tensor(self.rectifier[task_id], dtype=torch.float32, device=device)[labels]
            rect_scores = torch.pow(scores, 1.0 - rect) * torch.pow(iou.clamp(0.0, 1.0), rect)
            cls_ids = torch.arange(num_cls, device=device)
            lane_scores = torch.where(
                base_valid[..., None] & (labels[..., None] == cls_ids),
                rect_scores[..., None],
                NEG_INF,
            ).transpose(1, 2)  # (B, C, HW)
            lanes.append({
                "task_id": task_id, "b": b, "hw": hw, "num_cls": num_cls,
                "lane_scores": lane_scores, "pos3": pos3, "rect_scores": rect_scores,
                "preds": preds,
                "thresh": np.asarray(nms_cfg["nms_iou_threshold"][task_id], np.float32).reshape(-1),
            })

        n_tasks = len(lanes)
        all_boxes, all_scores, all_labels, all_valid = ([None] * n_tasks for _ in range(4))
        label_offsets = np.cumsum([0] + [t["num_cls"] for t in lanes])
        groups: dict[int, list] = {}
        for t in lanes:
            groups.setdefault(t["hw"], []).append(t)

        for hw, group in groups.items():
            b = group[0]["b"]
            c_tot = sum(t["num_cls"] for t in group)
            scores_g = torch.cat([t["lane_scores"] for t in group], dim=1).reshape(b * c_tot, hw)
            pre_cap = min(pre, hw)
            cand_scores, cand_idx = exact_top_k(scores_g, pre_cap)
            cand_idx = cand_idx.reshape(b, c_tot, pre_cap)

            boxes_parts, cls_start = [], 0
            for t in group:
                num_cls, preds = t["num_cls"], t["preds"]
                idx_b = cand_idx[:, cls_start:cls_start + num_cls].reshape(b, num_cls * pre_cap)

                def gather_b(dense, ix=idx_b):
                    return torch.gather(dense, 1, ix[..., None].expand(-1, -1, dense.shape[-1]))

                c_pos3 = gather_b(t["pos3"])
                if drv_fn is not None:
                    raw_dim, c_rot, c_vel = drv_fn(t["task_id"], idx_b)
                else:
                    raw_dim, c_rot, c_vel = (
                        gather_b(preds[n].float().reshape(b, hw, -1)) for n in SPARSE_NAMES
                    )
                c_yaw = torch.atan2(c_rot[..., 0:1], c_rot[..., 1:2])
                boxes_parts.append(
                    torch.cat([c_pos3, torch.exp(raw_dim), c_vel, c_yaw], dim=-1)
                    .reshape(b, num_cls, pre_cap, 9)
                )
                cls_start += num_cls

            cand_boxes = torch.cat(boxes_parts, dim=1).reshape(b * c_tot, pre_cap, 9)
            lane_thresh = np.tile(
                np.concatenate([np.broadcast_to(t["thresh"], (t["num_cls"],)) for t in group]), b
            )
            lane_thresh = torch.as_tensor(lane_thresh, device=device)
            if circle:
                sel_c, sel_valid = nms_lib.circle_nms(cand_boxes[..., :2], cand_scores, lane_thresh,
                                                      pre_cap, post)
            else:
                sel_c, sel_valid = nms_lib.rotated_nms(cand_boxes[..., [0, 1, 2, 3, 4, 5, 8]], cand_scores,
                                                       lane_thresh, pre_cap, post)
            sel_c = sel_c.reshape(b, c_tot, post)
            sel_valid = sel_valid.reshape(b, c_tot, post)
            cand_boxes = cand_boxes.reshape(b, c_tot, pre_cap, 9)

            cls_start = 0
            for t in group:
                num_cls, ti = t["num_cls"], t["task_id"]
                sl = slice(cls_start, cls_start + num_cls)
                all_boxes[ti] = torch.gather(
                    cand_boxes[:, sl], 2, sel_c[:, sl, :, None].expand(-1, -1, -1, 9)
                ).reshape(b, num_cls * post, 9)
                sel = torch.gather(cand_idx[:, sl], 2, sel_c[:, sl]).reshape(b, num_cls * post)
                all_scores[ti] = torch.gather(t["rect_scores"], 1, sel)
                labels = label_offsets[ti] + torch.arange(num_cls, dtype=torch.int32, device=device)
                all_labels[ti] = labels[:, None].expand(num_cls, post).reshape(1, -1).repeat(b, 1)
                all_valid[ti] = sel_valid[:, sl].reshape(b, num_cls * post)
                cls_start += num_cls

        valid = torch.cat(all_valid, dim=1)
        return {
            "box3d_lidar": torch.cat(all_boxes, dim=1),
            "scores": torch.where(valid, torch.cat(all_scores, dim=1), 0.0),
            "label_preds": torch.cat(all_labels, dim=1),
            "valid": valid,
        }
