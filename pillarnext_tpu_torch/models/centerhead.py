"""CenterPoint head: shared conv, per-task SepHeads, decode and NMS (eval).

Counterpart of ``SepHead`` / ``CenterHead`` (pillarnext_tpu/models/centerhead.py:43-157,
:303-470, :568-782).  Maps are NHWC at the module boundary.  With the
post-processing config's ``candidate_sparse_head``, hm/reg/height[/iou]
run dense while dim/rot/vel are evaluated only at the selected candidates,
on zero-padded (2R+1)^2 patches of the task's deblock output — the same
values as the dense maps at those cells.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from pillarnext_tpu_torch.core import nms as nms_lib
from pillarnext_tpu_torch.models.layers import BN_EPS_DENSE, BatchNorm, ConvTransposeBlock, conv2d
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
                BatchNorm(head_conv, BN_EPS_DENSE),
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
    """One task group's deblock and branch bank (centerhead.py:43-155)."""

    def __init__(self, in_ch, heads: Mapping[str, tuple], stride=1, head_conv=64,
                 init_bias=-2.19, final_kernel=3):
        super().__init__()
        self.names = list(heads)
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
        return {n: getattr(self, n)(x, mask).permute(0, 2, 3, 1) for n in names}


class CenterHead(nn.Module):
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
        voxel_size: Sequence[float] | None = None,
        pc_range: Sequence[float] | None = None,
        out_size_factor: Sequence[int] | None = None,
        rectifier: Sequence[Sequence[float]] = (),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if merge_tasks or merge_branches:
            raise NotImplementedError("merge_tasks / merge_branches not ported yet, see ROADMAP")
        # weight, code_weights and with_reg_iou configure the training loss
        # (not ported yet); kept so one config builds both
        self.loss_weight = weight
        self.code_weights = list(code_weights)
        self.with_reg_iou = with_reg_iou
        self.class_names = [list(t) for t in tasks]
        self.num_classes = [len(t) for t in tasks]
        self.common_heads = {k: (int(v[0]), int(v[1])) for k, v in common_heads.items()}
        self.num_hm_conv = num_hm_conv
        self.rectifier = [list(r) for r in rectifier]
        hc = share_conv_channel
        self.shared_conv = nn.Sequential(
            nn.Conv2d(in_channels, hc, 3, padding=1, bias=True), BatchNorm(hc, BN_EPS_DENSE)
        )
        seps = []
        for num_cls, stride in zip(self.num_classes, strides):
            heads = dict(self.common_heads)
            heads["hm"] = (num_cls, num_hm_conv)
            seps.append(SepHead(hc, heads, int(stride), hc, init_bias))
        self.tasks = nn.ModuleList(seps)

    def _shared(self, x):
        x = x.permute(0, 3, 1, 2)
        return torch.relu(self.shared_conv[1](conv2d(x, self.shared_conv[0])))

    def forward(self, x: torch.Tensor, test_cfg=None):
        """NHWC features -> per-task dicts of dense NHWC maps; with
        ``test_cfg`` and its ``candidate_sparse_head``, the detections."""
        x = self._shared(x)
        if test_cfg is None or not test_cfg.get("candidate_sparse_head", False):
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

    def predict(self, preds_dicts, test_cfg, drv_fn=None):
        """Decode + per-class rotated NMS with fixed-size outputs
        (centerhead.py:568-782): box3d_lidar (B, D, 9), scores (B, D),
        label_preds (B, D), valid (B, D), D = sum of classes x
        nms_post_max_size.  ``drv_fn(task_id, flat_idx) -> (dim, rot, vel)``
        supplies the regression values at the candidates (default: gather
        the dense maps)."""
        nms_cfg = test_cfg["nms"]
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
            sel_c, sel_valid = nms_lib.rotated_nms(
                cand_boxes[..., [0, 1, 2, 3, 4, 5, 8]],
                cand_scores,
                torch.as_tensor(lane_thresh, device=device),
                pre_cap,
                post,
            )
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
