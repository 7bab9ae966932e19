"""JAX ``{params, batch_stats}`` trees -> the port's state_dict (numpy only).

The port's own copy of ``export_pillarnext`` and its helpers
(pillarnext_tpu/utils/torch_import.py:378-518), for the standard (non-merged)
pillarnet18_aspp layout.  It writes the reference checkpoint schema the
port's modules use.  Layout conversions:

  Dense kernel (in, out)               -> Linear (out, in)
  Conv kernel (kh, kw, in, out)        -> Conv2d (out, in, kh, kw)
  ConvTranspose kernel (kh, kw, in, out), spatially flipped
                                       -> ConvTranspose2d (in, out, kh, kw)
  scale/bias + mean/var                -> BatchNorm weight/bias/running_*

Every map is linear in the tensor, so the same function carries gradients
(pass the gradient tree as ``params`` and any tree of the statistics'
shapes as ``batch_stats``).
"""

from __future__ import annotations

import numpy as np


def _inv_conv_kernel(k) -> np.ndarray:
    """flax Conv (H,W,I,O) -> torch Conv2d (O,I,H,W)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _inv_conv_transpose_kernel(k) -> np.ndarray:
    """flax ConvTranspose (H,W,I,O, spatially flipped) -> torch (I,O,H,W)."""
    k = np.asarray(k)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def _inv_bn(sd, torch_prefix, p, s):
    sd[f"{torch_prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{torch_prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{torch_prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{torch_prefix}.running_var"] = np.asarray(s["var"])


def _inv_conv_block(sd, prefix, p, s):
    sd[f"{prefix}.conv.weight"] = _inv_conv_kernel(p["Conv_0"]["kernel"])
    _inv_bn(sd, f"{prefix}.norm", p["BatchNorm_0"], s["BatchNorm_0"])


def _inv_residual_block(sd, prefix, p, s):
    _inv_conv_block(sd, f"{prefix}.block1", p["ConvBlock_0"], s["ConvBlock_0"])
    sd[f"{prefix}.conv2.weight"] = _inv_conv_kernel(p["Conv_0"]["kernel"])
    _inv_bn(sd, f"{prefix}.norm2", p["BatchNorm_0"], s["BatchNorm_0"])


def export_pillarnext(
    params,
    batch_stats,
    *,
    num_filters=(64, 64),
    layer_nums=(2, 2, 2, 2),
    tasks=(),
    common_heads=None,
    num_hm_conv=2,
) -> dict[str, np.ndarray]:
    """{params, batch_stats} -> a reference-named state_dict for the
    pillarnet18_aspp detector."""
    p, s = params, batch_stats
    sd: dict[str, np.ndarray] = {}

    for i in range(len(num_filters)):
        rp = p["reader"][f"pfn_layers_{i}"]
        rs = s["reader"][f"pfn_layers_{i}"]
        sd[f"reader.pfn_layers.{i}.linear.weight"] = np.ascontiguousarray(
            np.asarray(rp["Dense_0"]["kernel"]).T
        )
        _inv_bn(sd, f"reader.pfn_layers.{i}.norm", rp["MaskedBatchNorm_0"], rs["MaskedBatchNorm_0"])

    for si, n_blocks in enumerate(layer_nums):
        bp, bs = p["backbone"][f"stage_{si}"], s["backbone"][f"stage_{si}"]
        _inv_conv_block(sd, f"backbone.blocks.{si}.0", bp["down"], bs["down"])
        for bi in range(n_blocks):
            _inv_residual_block(
                sd, f"backbone.blocks.{si}.{bi + 1}", bp[f"block_{bi}"], bs[f"block_{bi}"]
            )
    sd["backbone.mapping.0.weight"] = _inv_conv_kernel(
        p["backbone"]["ConvBlock_0"]["Conv_0"]["kernel"]
    )
    _inv_bn(
        sd, "backbone.mapping.1",
        p["backbone"]["ConvBlock_0"]["BatchNorm_0"],
        s["backbone"]["ConvBlock_0"]["BatchNorm_0"],
    )

    _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv)
    return sd


def _export_neck_head(sd, p, s, tasks, common_heads, num_hm_conv=2):
    """ASPP neck + CenterHead export."""
    np_, ns = p["neck"], s["neck"]
    for j in range(2):
        _inv_conv_block(
            sd, f"neck.pre_conv.block{j + 1}",
            np_["BasicBlock_0"][f"ConvBlock_{j}"], ns["BasicBlock_0"][f"ConvBlock_{j}"],
        )
    sd["neck.conv1x1.weight"] = _inv_conv_kernel(np_["Conv_0"]["kernel"])
    sd["neck.weight"] = _inv_conv_kernel(np_["shared_dilated_kernel"])
    _inv_conv_block(sd, "neck.post_conv", np_["ConvBlock_0"], ns["ConvBlock_0"])

    hp, hs = p["head"], s["head"]
    sd["head.shared_conv.0.weight"] = _inv_conv_kernel(hp["shared_conv"]["kernel"])
    sd["head.shared_conv.0.bias"] = np.asarray(hp["shared_conv"]["bias"])
    _inv_bn(sd, "head.shared_conv.1", hp["shared_bn"], hs["shared_bn"])

    for ti, task in enumerate(tasks):
        tp, tsd = hp[f"task_{ti}"], hs[f"task_{ti}"]
        sd[f"head.tasks.{ti}.deblock.conv.weight"] = _inv_conv_transpose_kernel(
            tp["ConvTransposeBlock_0"]["ConvTranspose_0"]["kernel"]
        )
        _inv_bn(
            sd, f"head.tasks.{ti}.deblock.norm",
            tp["ConvTransposeBlock_0"]["BatchNorm_0"], tsd["ConvTransposeBlock_0"]["BatchNorm_0"],
        )
        branches = dict(common_heads)
        branches["hm"] = (len(task), num_hm_conv)
        for bname, (_n_out, n_conv) in branches.items():
            bp, bs = tp[bname], tsd[bname]
            ci = 0
            for li in range(n_conv - 1):
                t_conv = 3 * li
                sd[f"head.tasks.{ti}.{bname}.{t_conv}.weight"] = _inv_conv_kernel(
                    bp[f"Conv_{ci}"]["kernel"]
                )
                sd[f"head.tasks.{ti}.{bname}.{t_conv}.bias"] = np.asarray(bp[f"Conv_{ci}"]["bias"])
                _inv_bn(
                    sd, f"head.tasks.{ti}.{bname}.{t_conv + 1}",
                    bp[f"BatchNorm_{li}"], bs[f"BatchNorm_{li}"],
                )
                ci += 1
            t_final = 3 * (n_conv - 1)
            sd[f"head.tasks.{ti}.{bname}.{t_final}.weight"] = _inv_conv_kernel(
                bp[f"Conv_{ci}"]["kernel"]
            )
            sd[f"head.tasks.{ti}.{bname}.{t_final}.bias"] = np.asarray(bp[f"Conv_{ci}"]["bias"])
    return sd
